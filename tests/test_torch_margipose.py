"""The port's MargiPose model and masked loss against the JAX package.

A JAX MargiPose (inceptionv4, 2 stages, 64 px, BN stats randomised) is
exported into the port through ``state_dict_from_jax``; both run the same
numpy inputs in eval mode at float32. The port's loss (through the fused
head's plain version on the CPU) is held against both JAX loss routes: the
stacked XLA route and the Pallas route (``use_fused=True``, interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from margipose_tpu.models.margipose import margipose_masked_loss as jax_masked_loss
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.models.margipose import margipose_masked_loss, permute_axis
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_weights import jax_margipose, small_desc

PLANES = ('xy_heatmaps', 'zy_heatmaps', 'xz_heatmaps')


def _pair(desc, batch, seed):
    jax_model, variables = jax_margipose(desc, seed=seed)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    size = desc['settings'].get('input_size', 256)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, (batch, 17, 3)).astype(np.float32)
    jax_xyz, jax_out = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, x)
    with torch.inference_mode():
        xyz, out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return dict(jax_out=jax_out, jax_xyz=jax_xyz, out=out, xyz=xyz, target=target)


@pytest.fixture(scope='module', params=[True, False], ids=['permuted', 'unpermuted'])
def small_pair(request):
    return _pair(small_desc(axis_permutation=request.param), batch=2, seed=0)


def test_heatmaps_match_jax(small_pair):
    for plane in PLANES:
        for t, (hm, expected) in enumerate(zip(getattr(small_pair['out'], plane),
                                               getattr(small_pair['jax_out'], plane))):
            assert hm.shape == expected.shape == (2, 17, 8, 8)
            assert_allclose(hm.numpy(), np.asarray(expected), atol=1e-5,
                            err_msg=f'{plane} stage {t}')


def test_coords_match_jax(small_pair):
    assert_allclose(small_pair['xyz'].numpy(), np.asarray(small_pair['jax_xyz']), atol=1e-4)


def test_masked_loss_matches_both_jax_routes(small_pair):
    target = small_pair['target']
    valid_depth = np.array([1, 0], np.int32)
    mask = np.ones((2, 17), np.float32)
    mask[0, [3, 9]] = 0
    mask[1, 5] = 0
    jax_out = small_pair['jax_out']
    stacked = jax_masked_loss(jax_out, jnp.asarray(target), jnp.asarray(mask),
                              jnp.asarray(valid_depth), 'jsd')
    pallas = jax_masked_loss(jax_out._replace(stacked=()), jnp.asarray(target),
                             jnp.asarray(mask), jnp.asarray(valid_depth), 'jsd',
                             use_fused=True)
    loss = margipose_masked_loss(small_pair['out'], torch.from_numpy(target),
                                 torch.from_numpy(mask), torch.from_numpy(valid_depth))
    assert_allclose(float(loss), float(stacked), rtol=1e-4)
    assert_allclose(float(loss), float(pallas), rtol=1e-4)


@pytest.mark.parametrize('mode', ['xy', 'zy', 'xz'])
def test_permute_axis_matches_nhwc(mode):
    from margipose_tpu.models.margipose import permute_axis_nhwc

    x = np.random.RandomState(0).randn(2, 4, 4, 12).astype(np.float32)
    expected = np.asarray(permute_axis_nhwc(jnp.asarray(x), mode))
    got = permute_axis(torch.from_numpy(x).permute(0, 3, 1, 2), mode)
    assert_allclose(got.permute(0, 2, 3, 1).numpy(), expected, atol=0)


@pytest.mark.slow
def test_full_flagship_matches_jax():
    """MargiPose v6.0.1 at full width: inceptionv4, 4 stages, 256 px."""
    desc = small_desc(n_stages=4, input_size=256)
    pair = _pair(desc, batch=1, seed=3)
    for plane in PLANES:
        for hm, expected in zip(getattr(pair['out'], plane), getattr(pair['jax_out'], plane)):
            assert hm.shape == (1, 17, 32, 32)
            assert_allclose(hm.numpy(), np.asarray(expected), atol=1e-5, err_msg=plane)
    assert_allclose(pair['xyz'].numpy(), np.asarray(pair['jax_xyz']), atol=1e-4)
