"""The port's Chatterbox against the JAX package's, on the CPU.

Chatterbox cannot run below 256 px (its (1, 8) kernels need width 8 after
two stride-2 convolutions), so the model's tests run at full width and
256 px, batch 1-2. The weights are the port's seeded initialisation with BN
statistics from one train-mode pass, perturbed, and the three heads' last
1x1 convolutions scaled down so the heatmaps are neither flat nor one-hot;
they reach the JAX model through the JAX package's importer and come back
through the port's ``state_dict_from_jax``, which must load them strict.

Tolerances (float32 on the CPU, sums in another order): blocks atol 1e-5
(the XY head's unnormalised logits 1e-5 of their peak), the masked loss rtol
1e-4, coordinates atol 1e-4. The full model's heatmaps atol 1e-4, as
chip_smoke.py holds the card against the CPU: the rounding grows through the
75.6 M parameters of the heads, and the heatmaps measure 3.94e-5 from JAX's
at most (the xz plane, peak about 0.9; on this test's two torch threads),
four times what a 1e-5 limit would allow. One train step with the
tolerances of tests/test_torch_train_step.py, but each parameter within
1e-4 + 4% (not 2%) of the largest update the JAX step made to it:
train-mode batch norm over the heads' narrow maps amplifies rounding far
more than in MargiPose. Measured, the worst parameter lies at 0.94 of that
limit (zy_hm_cnn.up_convs.0.weight, 1.22e-4 from JAX's where the update is
7.5e-4 at most); the ResNet-stem MargiPose step, under the 2% rule, at
0.002 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.models.chatterbox as jax_cb
import margipose_tpu.train.steps as jax_steps
import margipose_tpu_torch.models.margipose as port_margipose
from margipose_tpu.models import create_model as create_jax_model
from margipose_tpu.models.margipose import margipose_masked_loss as jax_masked_loss
from margipose_tpu.train.schedules import make_optimiser as jax_make_optimiser
from margipose_tpu.train.torch_import import convert_state_dict, export_state_dict
from margipose_tpu_torch.models import Default_Chatterbox_Desc, create_model
from margipose_tpu_torch.models.chatterbox import (
    CbDownBlock,
    CbUpBlock,
    ChatterboxModel,
    XYCnn,
)
from margipose_tpu_torch.models.layers import init_parameters
from margipose_tpu_torch.models.margipose import margipose_masked_loss
from margipose_tpu_torch.train.steps import make_train_step
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_train_step import SCHEDULE, _assert_state_matches, _batch, _port_state, _torch_batch
from test_torch_weights import port_init_as_jax, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures('two_torch_threads')

DESC = Default_Chatterbox_Desc
PLANES = ('xy_heatmaps', 'zy_heatmaps', 'xz_heatmaps')
# the heads' last convolutions scaled: mean heatmap peaks of about 0.15-0.25
HEAD_SCALES = {'xy_hm_cnn': 0.3, 'zy_hm_cnn': 0.6, 'xz_hm_cnn': 0.6}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def calibrate(model, seed, batch=2):
    """BN running stats from one train-mode pass over a numpy batch, then
    perturbed; the heads' last 1x1 convolutions scaled by HEAD_SCALES."""
    rng = np.random.RandomState(seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # a cumulative average: one pass leaves the batch stats
    model.train()(_nchw(rng.randn(batch, 256, 256, 3).astype(np.float32)))
    for bn in bns:
        bn.momentum = 0.1
        n = bn.num_features
        bn.running_mean += torch.from_numpy(0.05 * rng.randn(n).astype(np.float32))
        bn.running_var *= torch.from_numpy(rng.uniform(0.8, 1.25, n).astype(np.float32))
    for conv, head in ((model.xy_hm_cnn.hm_conv, 'xy_hm_cnn'),
                       (model.zy_hm_cnn.up_convs[7], 'zy_hm_cnn'),
                       (model.xz_hm_cnn.up_convs[7], 'xz_hm_cnn')):
        conv.weight *= HEAD_SCALES[head]
    return model.eval()


def jax_chatterbox(seed):
    """(JAX Chatterbox, its numpy variables, the port's model loaded from
    them through ``state_dict_from_jax``)."""
    port = calibrate(create_model(DESC, generator=torch.Generator().manual_seed(seed)), seed)
    jax_model = create_jax_model(DESC)
    variables = port_init_as_jax(None, module=(jax_model, port), shape=(1, 256, 256, 3))
    model = create_model(DESC)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jax_model, variables, model.eval()


@pytest.fixture(scope='module')
def pair():
    jax_model, variables, model = jax_chatterbox(seed=0)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 256, 256, 3).astype(np.float32)
    jax_xyz, jax_out = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, x)
    with torch.inference_mode():
        xyz, out = model(_nchw(x))
    return dict(variables=variables, model=model, jax_out=jax_out, jax_xyz=jax_xyz, out=out,
                xyz=xyz, target=rng.uniform(-0.8, 0.8, (1, 17, 3)).astype(np.float32))


def test_heatmaps_and_coords_match_jax(pair):
    for plane in PLANES:
        (hm,), (expected,) = getattr(pair['out'], plane), getattr(pair['jax_out'], plane)
        assert hm.shape == (1, 17, 32, 32) and hm.dtype == torch.float32
        assert 0.05 < hm.amax((2, 3)).mean() < 0.9, 'heatmaps flat or one-hot'
        assert_allclose(hm.numpy(), np.asarray(expected), atol=1e-4, err_msg=plane)
    assert pair['xyz'].shape == (1, 17, 3)
    assert_allclose(pair['xyz'].numpy(), np.asarray(pair['jax_xyz']), atol=1e-4)


@pytest.mark.parametrize('route', ['jnp', 'pallas'])
def test_masked_loss_through_one_grouped_call(pair, route, monkeypatch):
    """One ``dsnt_jsd_grouped`` call of 3 groups (one stage x 3 planes), as
    the JAX package's ``_stage_components`` reaches its Pallas head for
    Chatterbox (no ``stacked`` field). The JAX side: its jnp head, and the
    Pallas kernel in interpret mode."""
    calls = []
    grouped = port_margipose.dsnt_jsd_grouped

    def counting(heatmaps, mus, sigma):
        calls.append(len(heatmaps))
        return grouped(heatmaps, mus, sigma)

    monkeypatch.setattr(port_margipose, 'dsnt_jsd_grouped', counting)
    target = pair['target']
    mask = np.ones((1, 17), np.float32)
    mask[0, [2, 11]] = 0
    valid_depth = np.array([1], np.int32)
    assert pair['jax_out'].stacked == ()
    expected = jax_masked_loss(pair['jax_out'], jnp.asarray(target), jnp.asarray(mask),
                               jnp.asarray(valid_depth), 'jsd', use_fused=route == 'pallas')
    loss = margipose_masked_loss(pair['out'], torch.from_numpy(target), torch.from_numpy(mask),
                                 torch.from_numpy(valid_depth))
    assert calls == [3]
    assert_allclose(float(loss), float(expected), rtol=1e-4)


def test_state_dict_keys_are_the_exported_ones(pair):
    """The port's keys are ``export_state_dict``'s (the reference's), and the
    bridge gives the exporter's arrays: the transposed convolutions of the
    up path (dilated, asymmetric strides) back in torch's IOHW layout."""
    ref = export_state_dict(pair['variables'])
    ours = state_dict_from_jax(pair['variables'])
    assert set(ours) == set(ref) == set(create_model(DESC).state_dict())
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    for plane in ('zy', 'xz'):
        for key in (f'{plane}_hm_cnn.up_convs.0.weight', f'{plane}_hm_cnn.up_convs.4.conv1.weight',
                    f'{plane}_hm_cnn.up_convs.6.resample.0.weight'):
            assert torch.equal(ours[key], pair['model'].state_dict()[key]), key
    assert ours['zy_hm_cnn.up_convs.0.weight'].shape == (1024, 512, 1, 8)
    assert ours['xz_hm_cnn.up_convs.0.weight'].shape == (1024, 512, 8, 1)
    assert ours['zy_hm_cnn.down_convs.0.resample.1.running_var'].shape == (256,)


def _block_case(kind, shrink_width):
    """(JAX block, port block, key prefix in the model, NHWC input shape):
    a Chatterbox head's blocks at their real widths on small inputs."""
    def f(a, b):
        return (a, b) if shrink_width else (b, a)

    plane = 'zy' if shrink_width else 'xz'
    if kind == 'down_0':
        kw = dict(stride=f(1, 2), dilation=f(2, 1), dilation_in=f(1, 1))
        return (jax_cb.CbDownBlock(256, **kw), CbDownBlock(128, 256, **kw),
                f'{plane}_hm_cnn.down_convs.0', (2, 8, 8, 128))
    if kind == 'down_2':
        kw = dict(stride=f(1, 2), dilation=f(4, 1), dilation_in=f(2, 1))
        return (jax_cb.CbDownBlock(512, **kw), CbDownBlock(256, 512, **kw),
                f'{plane}_hm_cnn.down_convs.2', (2, 8, 8, 256))
    if kind == 'up_3':
        kw = dict(dilation=f(4, 1))
        return (jax_cb.CbUpBlock(512, **kw), CbUpBlock(512, 512, **kw),
                f'{plane}_hm_cnn.up_convs.3', (2,) + f(8, 4) + (512,))
    if kind == 'up_4':
        kw = dict(stride=f(1, 2), dilation=f(2, 1), dilation_in=f(4, 1), output_padding=f(0, 1))
        return (jax_cb.CbUpBlock(256, **kw), CbUpBlock(512, 256, **kw),
                f'{plane}_hm_cnn.up_convs.4', (2,) + f(8, 4) + (512,))
    kw = dict(stride=f(1, 2), dilation=f(1, 1), dilation_in=f(2, 1), output_padding=f(0, 1))
    return (jax_cb.CbUpBlock(128, **kw), CbUpBlock(256, 128, **kw),
            f'{plane}_hm_cnn.up_convs.6', (2,) + f(8, 4) + (256,))


def _flax_names(prefix):
    """'zy_hm_cnn.up_convs.4' -> ('zy_hm_cnn', 'up_4'): the block's flax path."""
    head, section, index = prefix.split('.')
    return head, f"{section.split('_')[0]}_{index}"


@pytest.mark.parametrize('shrink_width', [True, False], ids=['zy', 'xz'])
@pytest.mark.parametrize('kind', ['down_0', 'down_2', 'up_3', 'up_4', 'up_6'])
def test_blocks_match_jax(kind, shrink_width):
    jax_block, block, prefix, shape = _block_case(kind, shrink_width)
    init_parameters(block, torch.Generator().manual_seed(3))
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.randn(m.num_features)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, m.num_features)))
    template = jax.eval_shape(jax_block.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    sd = {f'{prefix}.{k}': v for k, v in block.state_dict().items()}
    head, name = _flax_names(prefix)
    # nested at the block's place in the model, so that both bridges see the
    # model's paths (the transposed-conv patterns need them)
    variables = convert_state_dict({c: {head: {name: t}} for c, t in template.items()}, sd)
    back = state_dict_from_jax(variables)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    variables = {c: v[head][name] for c, v in variables.items()}
    x = rng.randn(*shape).astype(np.float32)
    expected = jax.jit(lambda v, x: jax_block.apply(v, x, train=False))(variables, x)
    with torch.inference_mode():
        out = block.eval()(_nchw(x))
    assert out.permute(0, 2, 3, 1).shape == expected.shape
    assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(expected), atol=1e-5)


def test_xy_head_matches_jax():
    """The dilated ResNet-34 layer3/4 (stride -> dilation surgery) and the
    1x1 heatmap conv, at 512 channels on an 8x8 input."""
    jax_head, head = jax_cb.XYCnn(17), XYCnn(17)
    init_parameters(head, torch.Generator().manual_seed(5))
    rng = np.random.RandomState(6)
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, m.num_features)))
    x = rng.randn(2, 8, 8, 128).astype(np.float32)
    variables = port_init_as_jax(None, module=(jax_head, head), shape=x.shape)
    head.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert head.layer2[1].conv1.dilation == (4, 4) and head.layer2[0].conv1.stride == (1, 1)
    expected = jax.jit(lambda v, x: jax_head.apply(v, x, train=False))(variables, x)
    with torch.inference_mode():
        out = head.eval()(_nchw(x))
    assert out.shape == (2, 17, 8, 8)
    # unscaled logits of order 10: float32 sums of 4,608 terms a 3x3 conv,
    # held at 1e-5 of the output's peak
    expected = np.asarray(expected)
    assert_allclose(out.permute(0, 2, 3, 1).numpy(), expected,
                    atol=1e-5 * np.abs(expected).max())


def test_train_step_matches_jax():
    """One 1cycle step at batch 2, 256 px. The heads' width-1 maps (32 x 1
    after down_4) give their batch norms n = 64 values a channel, so the
    running-variance repair's n/(n-1) is 1.6% there."""
    jax_model, variables, _ = jax_chatterbox(seed=2)
    batch = _batch(seed=21, size=256)
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    jax_state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
    jax_state, jax_metrics = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False)(
        jax_state, jax.tree.map(jnp.asarray, batch))
    expected = state_dict_from_jax(jax.tree.map(np.asarray, {
        'params': jax_state.params, 'batch_stats': jax_state.batch_stats}))
    state = _port_state(variables, DESC)
    metrics = make_train_step('jsd')(state, _torch_batch(batch))
    assert_allclose(float(metrics['loss']), float(jax_metrics['loss']), rtol=1e-4)
    assert_allclose(metrics['pred'].numpy(), np.asarray(jax_metrics['pred']), atol=1e-4)
    _assert_state_matches(state.model.state_dict(), expected, state_dict_from_jax(variables),
                          update_share=0.04)


@pytest.mark.parametrize('version', ['1.3.0', '1.4.2'])
def test_registry_dispatches_chatterbox(version):
    model = create_model({'type': 'chatterbox', 'version': version,
                          'settings': {'pixelwise_loss': 'jsd'}})
    assert isinstance(model, ChatterboxModel) and model.pixelwise_loss == 'jsd'
    with pytest.raises(ValueError, match='unrecognised model'):
        create_model({'type': 'chatterbox', 'version': '2.0.0', 'settings': {}})
