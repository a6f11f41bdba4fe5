"""The port's train step against the JAX package's.

A calibrated JAX MargiPose (``test_torch_weights.jax_margipose``: 2 stages,
64 px) is exported into the port through ``state_dict_from_jax``; both take
one 1cycle step on the same numpy batch (B=2, masked joints, one 2D-only
example; and a mixed 2D/3D batch with half the 2D example's joints masked
and targets off the map). The JAX step is
``margipose_tpu.train.steps.make_train_step`` on
each of its loss routes: the default stacked XLA route, and the Pallas
DSNT+JSD route (``use_fused=True``, in interpret mode on the CPU). The port's
step goes through ``dsnt_jsd_fused``, whose CPU gradient is autograd over its
plain version.

Tolerances, all float32 on the CPU with sums in another order:
  loss                  rtol 1e-4, as tests/test_torch_margipose.py holds the
                        eval loss;
  parameters            1e-4 + 2% of the largest update the JAX step made to
                        the tensor. Train-mode batch norm over as few as 8
                        values a channel (B=2, 2x2 maps) amplifies rounding:
                        at this shape the port's own float32 step differs from
                        its float64 step by 1% of the update on the stem's
                        first convolution and by up to 5e-5 on tensors whose
                        update is 1e-4;
  running mean and var  rtol 1e-4, atol 1e-5. Torch's unbiased variance would
                        be off by 0.3% of the batch term at n = 32.

The port's forward (``make_forward_fn``) is held to the JAX package's
``make_forward_fn`` on the same numpy inputs: a JAX MargiPose (inceptionv4, 2
stages, 64 px, BN statistics randomised) exported into the port, batch 2,
float32, ``atol=1e-5`` on the coordinates (float32 summation order; the
coordinates lie in [-1, 1]). A (1, 1) mesh of one process gives what no mesh
gives; a mesh with a 'model' axis over 1 refuses an unsharded model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.train.steps as jax_steps
from margipose_tpu.models.margipose import margipose_masked_loss as jax_masked_loss
from margipose_tpu.train.schedules import make_optimiser as jax_make_optimiser
from margipose_tpu.train.steps import make_forward_fn as jax_make_forward_fn
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.models.layers import BatchNorm2d
from margipose_tpu_torch.parallel.mesh import Mesh, make_mesh
from margipose_tpu_torch.train import steps
from margipose_tpu_torch.train.schedules import make_optimiser
from margipose_tpu_torch.train.steps import (
    TrainState,
    make_eval_step,
    make_forward_fn,
    make_train_step,
)
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

SCHEDULE = dict(max_iters=10)  # 1cycle: lr 0.1, momentum 0.9 at the first update


def _batch(seed, batch=2, size=64):
    rng = np.random.RandomState(seed)
    mask = np.ones((batch, 17), np.float32)
    mask[0, [3, 9]] = 0
    mask[1, 5] = 0
    return {
        'input': rng.randn(batch, size, size, 3).astype(np.float32),
        'target': rng.uniform(-0.8, 0.8, (batch, 17, 3)).astype(np.float32),
        'joint_mask': mask,
        'valid_depth': np.array([1, 0][:batch], np.int32),
    }


def _mixed_batch(seed, size=64):
    """The mixed 2D/3D recipe's rows (an MPI-INF-3DHP and an MPII example):
    the 2D example has half its joints masked and targets off the map, as
    MPII joints that leave the crop are (margipose_tpu/data/mpii.py:247-250),
    so its zy/xz planes get no gradient and its target Gaussians underflow."""
    batch = _batch(seed, size=size)
    batch['joint_mask'][1] = np.arange(17) % 2
    off = [0, 1, 2, 7, 8]  # masked (even) and unmasked (odd) joints
    batch['target'][1, off, :2] = np.random.RandomState(seed).uniform(1.5, 3.0, (5, 2)) * [1, -1]
    return batch


def _torch_batch(batch):
    return {
        'input': torch.from_numpy(batch['input']).permute(0, 3, 1, 2).contiguous(),
        'target': torch.from_numpy(batch['target']),
        'joint_mask': torch.from_numpy(batch['joint_mask']),
        'valid_depth': torch.from_numpy(batch['valid_depth'].astype(np.int64)),
    }


def _port_state(variables, desc):
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, **SCHEDULE))


@pytest.fixture(scope='module')
def calibrated():
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=4)
    return desc, jax_model, variables


def _fused_route(out, *args, **kwargs):
    return jax_masked_loss(out._replace(stacked=()), *args, use_fused=True, **kwargs)


@pytest.mark.parametrize('route,make_batch', [
    ('stacked', _batch), ('pallas', _batch), ('stacked', _mixed_batch), ('pallas', _mixed_batch)],
    ids=['stacked', 'pallas', 'stacked-mixed_2d_3d', 'pallas-mixed_2d_3d'])
def test_train_step_matches_jax(calibrated, route, make_batch, monkeypatch):
    desc, jax_model, variables = calibrated
    batch = make_batch(seed=11)
    if route == 'pallas':
        monkeypatch.setattr(jax_steps, 'margipose_masked_loss', _fused_route)
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    jax_state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
    step = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False)
    jax_state, jax_metrics = step(jax_state, jax.tree.map(jnp.asarray, batch))
    expected = state_dict_from_jax(jax.tree.map(np.asarray, {
        'params': jax_state.params, 'batch_stats': jax_state.batch_stats}))

    state = _port_state(variables, desc)
    metrics = make_train_step('jsd')(state, _torch_batch(batch))
    assert state.step == 1 and state.optimiser.count == 1
    assert metrics['loss'].device.type == 'cpu' and not metrics['loss'].requires_grad
    assert_allclose(float(metrics['loss']), float(jax_metrics['loss']), rtol=1e-4)
    assert_allclose(metrics['pred'].numpy(), np.asarray(jax_metrics['pred']), atol=1e-4)

    _assert_state_matches(state.model.state_dict(), expected, state_dict_from_jax(variables))


def _assert_state_matches(got, expected, initial, update_share=0.02):
    """The port's state_dict after a step against the JAX step's, with the
    tolerances of the module docstring (each parameter within 1e-4 +
    ``update_share`` of the largest update the JAX step made to it)."""
    assert set(got) == set(expected)
    for key, want in expected.items():
        if key.endswith('num_batches_tracked'):
            assert int(got[key]) == 1, key
        elif 'running_' in key:
            assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-4, atol=1e-5, err_msg=key)
        else:
            update = np.abs(want.numpy() - initial[key].numpy()).max()
            assert_allclose(got[key].numpy(), want.numpy(), rtol=0,
                            atol=1e-4 + update_share * update,
                            err_msg=key)


def test_batch_norm_running_var_is_flax_biased_ema():
    """One train-mode pass at B=2, 4x4 (n = 32 per channel) against flax's
    BatchNorm. Stock nn.BatchNorm2d folds in the unbiased variance, 32/31 of
    the biased one, and fails the same check."""
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 4, 4, 8) * 3 + 1).astype(np.float32)
    old_var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    old_mean = rng.randn(8).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {'params': variables['params'],
                 'batch_stats': {'mean': jnp.asarray(old_mean), 'var': jnp.asarray(old_var)}}
    y, upd = flax_bn.apply(variables, jnp.asarray(x), mutable=['batch_stats'])

    def torch_run(cls):
        bn = cls(8)
        bn.running_mean.copy_(torch.from_numpy(old_mean))
        bn.running_var.copy_(torch.from_numpy(old_var))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
        out = bn.train()(xt)
        out.square().sum().backward()  # the fix-up must not break autograd
        return bn, out

    bn, out = torch_run(BatchNorm2d)
    assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), atol=1e-5)
    assert_allclose(bn.running_mean.numpy(), np.asarray(upd['batch_stats']['mean']), atol=1e-6)
    assert_allclose(bn.running_var.numpy(), np.asarray(upd['batch_stats']['var']), rtol=1e-6)
    assert int(bn.num_batches_tracked) == 1

    stock, _ = torch_run(torch.nn.BatchNorm2d)
    with pytest.raises(AssertionError):
        assert_allclose(stock.running_var.numpy(), np.asarray(upd['batch_stats']['var']),
                        rtol=1e-6)


def test_batch_norm_cumulative_average_is_biased_too():
    """momentum=None (a cumulative average, as chip_smoke.py calibrates with):
    one pass from reset stats leaves exactly the biased batch variance."""
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 4, 4).astype(np.float32))
    bn = BatchNorm2d(3, momentum=None)
    bn.train()(x)
    assert_allclose(bn.running_var.numpy(), x.var(dim=(0, 2, 3), unbiased=False).numpy(),
                    rtol=1e-5)


def test_eval_step_leaves_the_stats_alone(calibrated):
    desc, _, variables = calibrated
    state = _port_state(variables, desc)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = make_eval_step('jsd')(state.model, _torch_batch(_batch(seed=2)))
    assert metrics['pred'].shape == (2, 17, 3) and torch.isfinite(metrics['loss'])
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_loss_falls_on_a_fixed_batch():
    """As tests/test_train.py::test_train_step_reduces_loss: a freshly
    initialised model memorising one batch under 1cycle."""
    model = create_model(small_desc(), generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 0.05, max_iters=30))
    step = make_train_step('jsd')
    batch = _torch_batch(_batch(seed=7))
    losses = [float(step(state, batch)['loss']) for _ in range(10)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses
    assert state.step == 10


def _graph_state(algorithm='1cycle'):
    model = create_model(small_desc(), generator=torch.Generator().manual_seed(1))
    return TrainState(model, make_optimiser(algorithm, model.parameters(), 0.05, max_iters=30,
                                            milestones=[1], gamma=0.5, steps_per_epoch=5))


def test_the_graph_key_is_none_wherever_the_step_runs_eagerly(monkeypatch):
    """``graph_key`` decides where a step may be captured: never on the CPU,
    under a process group, on a mesh or with RMSprop; a changed shape or
    dtype, another step function or ``load_state_dict`` makes another key
    (its first step runs eagerly). Off the card the rest of the rule is
    read by counting the CPU as a graph device."""
    state, batch = _graph_state(), _torch_batch(_batch(seed=3))
    step, other = make_train_step('jsd'), make_train_step('jsd')
    assert steps.graph_key(step, state, batch) is None  # the CPU
    monkeypatch.setattr(steps, 'GRAPH_DEVICES', ('cuda', 'cpu'))
    key = steps.graph_key(step, state, batch)
    assert key is not None and key == steps.graph_key(step, state, _torch_batch(_batch(seed=4)))
    assert steps.graph_key(step, state, batch, mesh=object()) is None
    short = {k: v[:1] for k, v in batch.items()}
    assert steps.graph_key(step, state, short) not in (None, key)
    half = dict(batch, input=batch['input'].to(torch.bfloat16))
    assert steps.graph_key(step, state, half) not in (None, key)
    assert steps.graph_key(other, state, batch) not in (None, key)
    assert steps.graph_key(step, _graph_state('rmsprop'), batch) is None
    state.optimiser.load_state_dict(state.optimiser.state_dict())
    assert steps.graph_key(step, state, batch) not in (None, key)
    monkeypatch.setattr(steps, 'group_active', lambda: True)
    assert steps.graph_key(step, state, batch) is None


def test_a_cpu_step_runs_eagerly_and_returns_fresh_tensors():
    """On the CPU every step is eager (no graph is kept) and each call's
    loss and pred are tensors of their own, which a later step leaves
    alone."""
    state, step = _graph_state(), make_train_step('jsd')
    outs = [step(state, _torch_batch(_batch(seed=s))) for s in (5, 6, 7)]
    assert (step.eager_steps, step.captures, step.replays) == (3, 0, 0)
    assert state.graph is None and state.warmed is None and state.step == 3
    kept = [(o['loss'].clone(), o['pred'].clone()) for o in outs]
    step(state, _torch_batch(_batch(seed=8)))
    for out, (loss, pred) in zip(outs, kept):
        assert torch.equal(out['loss'], loss) and torch.equal(out['pred'], pred)
    ptrs = [o[k].data_ptr() for o in outs for k in ('loss', 'pred')]
    assert len(set(ptrs)) == len(ptrs)
    assert len({float(o['loss']) for o in outs}) == 3


@pytest.fixture(scope='module')
def pair():
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=0)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_make_forward_fn(jax_model)(variables, x))
    return model, x, want


@pytest.mark.parametrize('mesh', [None, (1, 1)], ids=['no mesh', '(1, 1) mesh'])
def test_forward_matches_jax(pair, mesh):
    model, x, want = pair
    model.train()  # the forward puts it in eval mode
    forward = make_forward_fn(model, compute_dtype='float32',
                              mesh=None if mesh is None else make_mesh(mesh))
    xyz = forward(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert xyz.dtype == torch.float32 and xyz.shape == want.shape == (2, 17, 3)
    assert not xyz.requires_grad and not model.training
    assert_allclose(xyz.numpy(), want, atol=1e-5)


def test_forward_on_a_model_axis_needs_the_sharded_model(pair):
    hybrid = Mesh(shape={'data': 1, 'model': 2}, coords={'data': 0, 'model': 0})
    with pytest.raises(ValueError, match='shard_variables'):
        make_forward_fn(pair[0], mesh=hybrid)


@pytest.mark.slow
def test_four_stage_train_step_matches_jax():
    """The flagship's depth (4 stages) and widths, at 128 px and B=2: the
    stem, all four stages' columns and combiners in one step. The full
    256 px flagship step is held card against CPU by chip_smoke.py."""
    desc = small_desc(n_stages=4, input_size=128)
    jax_model, variables = jax_margipose(desc, seed=5)
    batch = _batch(seed=13, size=128)
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    jax_state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
    jax_state, jax_metrics = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False)(
        jax_state, jax.tree.map(jnp.asarray, batch))
    state = _port_state(variables, desc)
    metrics = make_train_step('jsd')(state, _torch_batch(batch))
    assert_allclose(float(metrics['loss']), float(jax_metrics['loss']), rtol=1e-4)
    expected = state_dict_from_jax(jax.tree.map(np.asarray, {
        'params': jax_state.params, 'batch_stats': jax_state.batch_stats}))
    _assert_state_matches(state.model.state_dict(), expected, state_dict_from_jax(variables))
