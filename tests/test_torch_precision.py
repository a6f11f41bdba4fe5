"""The port's bf16 policy against the JAX package's.

``margipose_tpu_torch.parallel.precision`` runs the convolutions under
``torch.autocast`` and keeps master weights, optimiser state, BN statistics
and the softmax / DSNT / loss head float32, as
``margipose_tpu/parallel/precision.py`` does with its compute-dtype scope.

A calibrated JAX MargiPose (``test_torch_weights.jax_margipose``: 2 stages,
64 px) goes into the port through ``state_dict_from_jax``. bf16 rounds at
other places in the two frameworks (and CPU autocast is not CUDA's), so the
forwards are compared statistically, with the bounds
``tests/test_precision.py`` holds JAX's own bf16 forward to against its f32
one: median < 0.02, mean < 0.05, no coordinate further than 0.5 (a
near-saturated softmax can move a coordinate by a whole heatmap cell).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import margipose_tpu.parallel.precision as jax_precision
import margipose_tpu.train.steps as jax_steps
from margipose_tpu.train.schedules import make_optimiser as jax_make_optimiser
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.models.layers import BatchNorm2d
from margipose_tpu_torch.parallel.precision import compute_dtype_scope, resolve_dtype
from margipose_tpu_torch.train.schedules import make_optimiser
from margipose_tpu_torch.train.steps import TrainState, make_train_step
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_train_step import _batch, _torch_batch
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

SCHEDULE = dict(max_iters=10)


def _assert_statistically_close(a, b):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.median(err) < 0.02, np.median(err)
    assert np.mean(err) < 0.05, np.mean(err)
    assert (err > 0.5).mean() == 0.0, err.max()


@pytest.fixture(scope='module')
def calibrated():
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=4)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return desc, jax_model, variables, model.eval()


def test_resolve_dtype_matches_jax_table():
    for name in ('float32', 'f32', 'bfloat16', 'bf16'):
        assert str(resolve_dtype(name)) == f'torch.{jnp.dtype(jax_precision.resolve_dtype(name))}'
    assert resolve_dtype(None) is jax_precision.resolve_dtype(None) is None
    assert resolve_dtype(torch.bfloat16) is torch.bfloat16
    for bad in ('fp8', 'float16'):
        with pytest.raises(ValueError):
            jax_precision.resolve_dtype(bad)
        with pytest.raises(ValueError):
            resolve_dtype(bad)


def test_scope_autocasts_convolutions_only_for_bf16():
    conv = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(1, 3, 8, 8)
    for precision in (None, 'float32', 'f32'):
        with compute_dtype_scope(precision, 'cpu'):
            assert conv(x).dtype == torch.float32
    with compute_dtype_scope('bfloat16', torch.device('cpu')):
        assert conv(x).dtype == torch.bfloat16
    assert conv(x).dtype == torch.float32  # the scope ends with the block
    with pytest.raises(ValueError):
        compute_dtype_scope(torch.float16, 'cpu')


def test_bf16_forward_close_to_jax_bf16_and_own_f32(calibrated):
    """Within the bounds of JAX's bf16 forward and of the port's float32
    one; the head stays float32. As JAX casts each convolution's input to
    the compute dtype, the stem's output, the combiner's (from the three
    float32 heatmaps) and the running input of stage 1's columns are bf16."""
    desc, jax_model, variables, model = calibrated
    x = np.random.RandomState(0).randn(4, 64, 64, 3).astype(np.float32)
    jax_bf16 = jax_steps.make_forward_fn(jax_model, compute_dtype='bfloat16')(
        variables, jnp.asarray(x))
    assert jax_bf16.dtype == jnp.float32

    seen = {}

    def output_dtype(name):
        def hook(module, args, out):
            seen[name] = out.dtype
        return hook

    def column_input(module, args):
        seen['stage 1 input'] = args[0].dtype

    inner = model.inner
    hooks = [inner.in_cnn.register_forward_hook(output_dtype('stem')),
             inner.hm_combiners[0].register_forward_hook(output_dtype('combiner')),
             inner.xy_hm_cnns[1].register_forward_pre_hook(column_input)]
    images = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    try:
        with torch.inference_mode(), compute_dtype_scope('bfloat16', 'cpu'):
            xyz, out = model(images)
    finally:
        for hook in hooks:
            hook.remove()
    with torch.inference_mode():
        xyz_f32, _ = model(images)
    assert seen == {'stem': torch.bfloat16, 'combiner': torch.bfloat16,
                    'stage 1 input': torch.bfloat16}
    assert xyz.dtype == torch.float32
    assert all(hm.dtype == torch.float32 for hms in out for hm in hms)
    _assert_statistically_close(xyz.numpy(), np.asarray(jax_bf16))
    _assert_statistically_close(xyz.numpy(), xyz_f32.numpy())
    assert not np.array_equal(xyz.numpy(), xyz_f32.numpy())  # bf16 really ran


def test_bf16_train_step_keeps_state_f32():
    """One bf16 step (1 stage, 64 px): parameters, their gradients, BN
    statistics and the optimiser's momentum stay float32. The loss is held
    to the JAX bf16 step's: within twice JAX's own bf16-vs-f32 loss gap on
    the same batch."""
    desc = small_desc(n_stages=1)
    jax_model, variables = jax_margipose(desc, seed=6)
    batch = _batch(seed=11)
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    jax_losses = {}
    for precision in ('float32', 'bfloat16'):
        state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
        step = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False,
                                         compute_dtype=precision)
        _, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        jax_losses[precision] = float(metrics['loss'])
    jax_gap = abs(jax_losses['bfloat16'] - jax_losses['float32'])
    assert jax_gap > 0

    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, **SCHEDULE))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = make_train_step('jsd', 'bfloat16')(state, _torch_batch(batch))
    loss = float(metrics['loss'])
    assert metrics['loss'].dtype == metrics['pred'].dtype == torch.float32
    assert abs(loss - jax_losses['bfloat16']) <= 2 * jax_gap, (loss, jax_losses)

    for key, value in model.state_dict().items():
        if not key.endswith('num_batches_tracked'):
            assert value.dtype == torch.float32, key
            assert not torch.equal(value, before[key]), key  # every tensor moved
    for p in model.parameters():
        assert p.grad.dtype == torch.float32
    buffers = [s['momentum_buffer'] for s in state.optimiser.optimiser.state.values()]
    assert len(buffers) == len(list(model.parameters()))
    assert all(b.dtype == torch.float32 for b in buffers)


def test_batch_norm_running_var_repair_holds_under_bf16():
    """A bf16 input (a convolution's output under autocast): the statistics
    stay float32 and fold in the biased variance of the batch, as flax's
    ``BatchNorm(dtype=bf16)`` computes it in float32."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 6, 4, 4).astype(np.float32) * 2 + 1)
    x16 = x.to(torch.bfloat16)
    bn = BatchNorm2d(6)
    old = bn.running_var.clone()
    out = bn.train()(x16)
    assert out.dtype == torch.bfloat16
    assert bn.running_var.dtype == bn.running_mean.dtype == torch.float32
    var = x16.float().var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 * old + 0.1 * var).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * x16.float().mean(dim=(0, 2, 3))).numpy(), atol=1e-6)
