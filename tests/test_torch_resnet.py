"""The port's ResNet stems and pretrained-stem graft against the JAX package.

Each stem (``models/resnet.ResNetStem``, resnet18/34/50) is held against
``margipose_tpu.models.resnet.ResNetStem`` at 64 px, batch 2. In eval mode
(BN stats randomised): atol 1e-5, float32 sums in another order. In train
mode: the updated BN stats rtol 1e-4, atol 1e-5; the output atol 5e-5
against the port's own float64 run and 2e-4 against JAX's. Train-mode batch
norm over few values a channel (2 x 8 x 8 in layer2) amplifies rounding,
and flax computes the batch variance in one float32 pass, E[x^2] - E[x]^2,
which loses digits where a channel's mean is large against its spread; the
JAX stem's float32 output lies further from a float64 run than the port's.
Measured over the three stems: 1.16e-4 from JAX's output at most (so a
1e-5 limit cannot hold) and 3.06e-5 from the port's float64 run.
MargiPose with each stem
at 1 and 2 stages, 64 px: heatmaps atol 1e-5, the masked loss rtol 1e-4, as
tests/test_torch_margipose.py holds the inceptionv4 flagship. The graft of
an ImageNet backbone (``train/pretrained.py``) must overwrite the leaves
that ``margipose_tpu.train.torch_import.convert_pretrained_stem`` does, and
nothing else. One train step with the resnet34 stem (the Chatterbox trunk's blocks) is
held to the JAX step with the tolerances of tests/test_torch_train_step.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.train.steps as jax_steps
from margipose_tpu.models.margipose import margipose_masked_loss as jax_masked_loss
from margipose_tpu.models.resnet import ResNetStem as JaxResNetStem
from margipose_tpu.train.schedules import make_optimiser as jax_make_optimiser
from margipose_tpu.train.torch_import import convert_pretrained_stem as jax_convert
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.models.layers import init_parameters
from margipose_tpu_torch.models.margipose import margipose_masked_loss
from margipose_tpu_torch.models.resnet import ResNetStem
from margipose_tpu_torch.train.pretrained import convert_pretrained_stem, load_pretrained_stem
from margipose_tpu_torch.train.steps import make_train_step
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_train_step import SCHEDULE, _assert_state_matches, _batch, _port_state, _torch_batch
from test_torch_weights import port_init_as_jax, two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures('two_torch_threads')

STEMS = ['resnet18', 'resnet34', 'resnet50']


def stem_desc(feature_extractor, n_stages=2, input_size=64):
    return {'type': 'margipose', 'version': '6.0.1',
            'settings': {'n_stages': n_stages, 'axis_permutation': True,
                         'feature_extractor': feature_extractor, 'pixelwise_loss': 'jsd',
                         'input_size': input_size}}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def calibrated(desc, seed):
    """(JAX MargiPose, its numpy variables): the port's seeded weights with
    BN stats from one train-mode pass over a numpy batch, perturbed, and the
    last residual block of every column scaled down (soft heatmaps), as
    ``test_torch_weights.jax_margipose`` calibrates, without compiling JAX's
    init or train-mode pass."""
    from margipose_tpu.models import create_model as create_jax_model

    model = create_model(desc, generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # a cumulative average: one pass leaves the batch stats
    model.train()(_nchw(rng.randn(2, 64, 64, 3).astype(np.float32)))
    for bn in bns:
        bn.momentum = 0.1
        bn.running_mean += torch.from_numpy(0.05 * rng.randn(bn.num_features).astype(np.float32))
        bn.running_var *= torch.from_numpy(rng.uniform(0.8, 1.25, bn.num_features)
                                           .astype(np.float32))
    for plane in ('xy', 'zy', 'xz'):
        for column in getattr(model.inner, f'{plane}_hm_cnns'):
            last = column.up_layers[4]
            for bn in (last.module[4], last.shortcut[1]):
                bn.weight *= 0.2
    jax_model = create_jax_model(desc)
    return jax_model, port_init_as_jax(None, module=(jax_model, model), shape=(1, 64, 64, 3))


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('variant', STEMS)
def test_stem_matches_jax(variant, train):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jax_stem = JaxResNetStem(variant=variant)
    stem = ResNetStem(variant)
    init_parameters(stem, torch.Generator().manual_seed(0))
    variables = port_init_as_jax(None, module=(jax_stem, stem), shape=x.shape)
    variables['batch_stats'] = jax.tree.map(
        lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables['batch_stats'])
    expected, upd = jax.jit(lambda v, x: jax_stem.apply(v, x, train=train,
                                                        mutable=['batch_stats']))(variables, x)
    stem.load_state_dict(state_dict_from_jax(variables), strict=True)
    out = stem.train(train)(_nchw(x))
    assert out.shape == (2, 128, 8, 8)
    assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(expected),
                    atol=2e-4 if train else 1e-5)
    if train:
        out64 = copy.deepcopy(stem).double()(_nchw(x).double())
        assert_allclose(out.detach().numpy(), out64.detach().numpy(), atol=5e-5)
        want = state_dict_from_jax({'batch_stats': jax.tree.map(np.asarray, upd['batch_stats'])})
        for key, value in want.items():
            if 'running_' in key:
                assert_allclose(stem.state_dict()[key].numpy(), value.numpy(), rtol=1e-4,
                                atol=1e-5, err_msg=key)


@pytest.mark.parametrize('n_stages', [1, 2])
@pytest.mark.parametrize('variant', STEMS)
def test_margipose_with_stem_matches_jax(variant, n_stages):
    desc = stem_desc(variant, n_stages)
    jax_model, variables = calibrated(desc, seed=2)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, (2, 17, 3)).astype(np.float32)
    mask = np.ones((2, 17), np.float32)
    mask[0, 4] = 0
    valid_depth = np.array([1, 0], np.int32)
    jax_xyz, jax_out = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, x)
    with torch.inference_mode():
        xyz, out = model.eval()(_nchw(x))
        loss = margipose_masked_loss(out, torch.from_numpy(target), torch.from_numpy(mask),
                                     torch.from_numpy(valid_depth))
    for plane in ('xy_heatmaps', 'zy_heatmaps', 'xz_heatmaps'):
        got, want = getattr(out, plane), getattr(jax_out, plane)
        assert len(got) == n_stages
        for t, (hm, expected) in enumerate(zip(got, want)):
            assert_allclose(hm.numpy(), np.asarray(expected), atol=1e-5,
                            err_msg=f'{plane} stage {t}')
    assert_allclose(xyz.numpy(), np.asarray(jax_xyz), atol=1e-4)
    expected = jax_masked_loss(jax_out, jnp.asarray(target), jnp.asarray(mask),
                               jnp.asarray(valid_depth), 'jsd')
    assert_allclose(float(loss), float(expected), rtol=1e-4)


def _random_jax_variables(desc, seed=0):
    """A JAX variables tree of the model's shapes, random, without compiling
    an init: numpy arrays from ``jax.eval_shape``."""
    from margipose_tpu.models import create_model as create_jax_model

    size = desc['settings'].get('input_size', 256)
    shapes = jax.eval_shape(create_jax_model(desc).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize('variant', STEMS)
def test_state_dict_from_jax_loads_strict(variant):
    desc = stem_desc(variant)
    sd = state_dict_from_jax(_random_jax_variables(desc))
    model = create_model(desc)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.inner.in_cnn[0].weight, sd['inner.in_cnn.0.weight'])
    if variant == 'resnet50':  # the 1x1 reduction conv has a bias, as TorchConv's default
        assert model.inner.in_cnn[6].bias.shape == (128,)


def _backbone(feature_extractor, seed):
    """A synthesised ImageNet backbone state_dict for ``feature_extractor``:
    torchvision resnet (conv1, bn1, layer1-4, fc) or pretrainedmodels
    inceptionv4 (features.0-21, last_linear), with the deeper blocks and the
    classifier as surplus keys."""
    gen = torch.Generator().manual_seed(seed)
    stem = create_model(stem_desc(feature_extractor, n_stages=1)).inner.in_cnn.state_dict()
    if feature_extractor == 'inceptionv4':
        heads = {str(i): f'features.{i}' for i in range(7)}
        extra = {'features.7.branch0.conv.weight': (384, 384, 1, 1),
                 'last_linear.weight': (1000, 1536), 'last_linear.bias': (1000,)}
    else:
        heads = {'0': 'conv1', '1': 'bn1', '4': 'layer1', '5': 'layer2'}
        extra = {'layer3.0.conv1.weight': (256, 128, 3, 3), 'fc.weight': (1000, 512),
                 'fc.bias': (1000,)}
    out = {}
    for key, value in stem.items():
        head, _, rest = key.partition('.')
        if head in heads:
            out[f'{heads[head]}.{rest}'] = (value.clone() if value.dtype == torch.int64 else
                                            torch.randn(value.shape, generator=gen))
    out.update({k: torch.randn(shape, generator=gen) for k, shape in extra.items()})
    return out


@pytest.mark.parametrize('feature_extractor', STEMS + ['inceptionv4'])
def test_pretrained_graft_matches_jax(feature_extractor, tmp_path):
    desc = stem_desc(feature_extractor, n_stages=1)
    variables = _random_jax_variables(desc)
    backbone = _backbone(feature_extractor, seed=5)
    initial = state_dict_from_jax(variables)
    expected = state_dict_from_jax(jax_convert(variables, backbone, feature_extractor))
    got = convert_pretrained_stem(initial, backbone, feature_extractor)
    assert set(got) == set(expected)
    fresh = {'inceptionv4': ('7', '8'), 'resnet50': ('6', '7')}.get(feature_extractor, ())
    for key, want in expected.items():
        assert torch.equal(got[key], want), key
        rel = key.split('.')[2:]
        grafted = (key.startswith('inner.in_cnn.') and rel[0] not in fresh
                   and not key.endswith('num_batches_tracked'))
        assert torch.equal(got[key], initial[key]) != grafted, key

    path = tmp_path / 'backbone.pth'
    torch.save({'state_dict': backbone}, path)
    model = create_model(desc)
    load_pretrained_stem(model, str(path), feature_extractor)
    for key, value in model.state_dict().items():
        if key.startswith('inner.in_cnn.') and key.split('.')[2] not in fresh:
            assert torch.equal(value, got[key]), key


@pytest.mark.parametrize('fault', ['missing', 'shape'])
def test_pretrained_graft_raises_as_jax_does(fault):
    variables = _random_jax_variables(stem_desc('resnet18', n_stages=1))
    backbone = _backbone('resnet18', seed=6)
    if fault == 'missing':
        del backbone['layer2.1.bn2.running_var']
        error = KeyError
    else:
        backbone['layer1.0.conv1.weight'] = torch.zeros(64, 64, 1, 1)
        error = ValueError
    with pytest.raises(error):
        jax_convert(variables, backbone, 'resnet18')
    with pytest.raises(error):
        convert_pretrained_stem(state_dict_from_jax(variables), backbone, 'resnet18')


def test_train_step_with_resnet_stem_matches_jax():
    """resnet34, 1 stage, 64 px, B=2: one 1cycle step on the stacked route
    of the JAX step. (resnet50 is not held here: at 64 px its bottleneck
    stem's train-mode batch norms, through flax's one-pass batch variance,
    put the JAX step's own float32 update of the stem's first conv further
    from a float64 step than the tolerance.)"""
    desc = stem_desc('resnet34', n_stages=1)
    jax_model, variables = calibrated(desc, seed=6)
    batch = _batch(seed=14)
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
