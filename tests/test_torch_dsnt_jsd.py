"""The port's DSNT ops and fused DSNT+JSD head against the JAX package.

Inputs are made with numpy from a seed and given to both packages. The JAX
fused head runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pallas.py runs it; the port's wrapper runs its plain version on a
CPU tensor. The CUDA kernel itself is compared with the plain version on the
card (``test_cuda_kernel_matches_plain`` here, and chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from margipose_tpu.ops.pallas_dsnt import dsnt_jsd_fused as jax_dsnt_jsd_fused
from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_fused, dsnt_jsd_plain

# the modules, not the functions the ops packages re-export under that name
jdsnt = importlib.import_module('margipose_tpu.ops.dsnt')
tdsnt = importlib.import_module('margipose_tpu_torch.ops.dsnt')


def _heatmaps(b, j, h, w, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, j, h, w) * 2).astype(np.float32)
    p = np.array(jdsnt.flat_softmax(jnp.asarray(logits)))
    mu = rng.uniform(-0.8, 0.8, (b, j, 2)).astype(np.float32)
    return logits, p, mu


@pytest.mark.parametrize('b,j,h,w,sigma', [
    (4, 17, 32, 32, 1.0),  # flagship rows
    (1, 3, 16, 24, 2.0),   # non-square
    (1, 13, 8, 8, 1.0),    # prime row count
])
def test_fused_matches_jax_pallas(b, j, h, w, sigma):
    _, p, mu = _heatmaps(b, j, h, w, seed=b * 100 + j)
    exp_coords, exp_jsd = jax_dsnt_jsd_fused(jnp.asarray(p), jnp.asarray(mu), sigma)
    coords, jsd = dsnt_jsd_fused(torch.from_numpy(p), torch.from_numpy(mu), sigma)
    assert coords.shape == (b, j, 2) and jsd.shape == (b, j)
    assert_allclose(coords.numpy(), np.asarray(exp_coords), atol=1e-5)
    assert_allclose(jsd.numpy(), np.asarray(exp_jsd), atol=1e-5)


def test_no_target_gradient_and_softmax_gradients_match_jax():
    logits, _, mu = _heatmaps(1, 4, 16, 16, seed=3)

    def jax_loss(lg):
        coords, jsd = jax_dsnt_jsd_fused(jdsnt.flat_softmax(lg), jnp.asarray(mu))
        return jnp.sum(coords ** 2) + jnp.sum(jsd)

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    mu_t = torch.from_numpy(mu).requires_grad_()
    coords, jsd = dsnt_jsd_fused(tdsnt.flat_softmax(lg), mu_t)
    ((coords ** 2).sum() + jsd.sum()).backward()
    assert mu_t.grad is None
    assert_allclose(lg.grad.numpy(), expected, atol=1e-5)


def test_plain_version_is_dsnt_and_js():
    _, p, mu = _heatmaps(2, 5, 8, 12, seed=7)
    coords, jsd = dsnt_jsd_plain(torch.from_numpy(p), torch.from_numpy(mu), 1.5)
    assert_allclose(coords.numpy(), np.asarray(jdsnt.dsnt(jnp.asarray(p))), atol=1e-6)
    assert_allclose(jsd.numpy(), np.asarray(
        jdsnt.js_reg_losses(jnp.asarray(p), jnp.asarray(mu), 1.5)), atol=1e-6)


@pytest.mark.parametrize('length', [1, 4, 7, 32])
def test_normalized_linspace(length):
    assert_allclose(tdsnt.normalized_linspace(length).numpy(),
                    np.asarray(jdsnt.normalized_linspace(length)), atol=1e-7)


@pytest.mark.parametrize('size,sigma', [(32, 1.0), (24, 2.0)])
def test_gauss_axis_coeff(size, sigma):
    assert tdsnt.gauss_axis_coeff(size, sigma) == jdsnt.gauss_axis_coeff(size, sigma)


def test_flat_softmax_and_dsnt_match_jax():
    logits, _, _ = _heatmaps(2, 4, 8, 12, seed=1)
    p_j = jdsnt.flat_softmax(jnp.asarray(logits))
    p_t = tdsnt.flat_softmax(torch.from_numpy(logits))
    assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-7)
    assert_allclose(tdsnt.dsnt(p_t).numpy(), np.asarray(jdsnt.dsnt(p_j)), atol=1e-6)


def test_make_gauss_and_js_reg_losses_match_jax():
    _, p, mu = _heatmaps(2, 3, 16, 24, seed=2)
    assert_allclose(tdsnt.make_gauss(torch.from_numpy(mu), (16, 24), 2.0).numpy(),
                    np.asarray(jdsnt.make_gauss(jnp.asarray(mu), (16, 24), 2.0)), atol=1e-7)
    assert_allclose(
        tdsnt.js_reg_losses(torch.from_numpy(p), torch.from_numpy(mu), 2.0).numpy(),
        np.asarray(jdsnt.js_reg_losses(jnp.asarray(p), jnp.asarray(mu), 2.0)), atol=1e-6)


def test_euclidean_and_masked_average_loss_match_jax():
    rng = np.random.RandomState(4)
    a, t = rng.randn(2, 2, 17, 3).astype(np.float32)
    losses = np.asarray(jdsnt.euclidean_losses(jnp.asarray(a), jnp.asarray(t)))
    got = tdsnt.euclidean_losses(torch.from_numpy(a), torch.from_numpy(t))
    assert_allclose(got.numpy(), losses, atol=1e-6)
    mask = (rng.rand(2, 17) > 0.3).astype(np.float32)
    for m in (mask, np.zeros_like(mask), None):
        expected = jdsnt.average_loss(jnp.asarray(losses),
                                      None if m is None else jnp.asarray(m))
        value = tdsnt.average_loss(torch.from_numpy(losses),
                                   None if m is None else torch.from_numpy(m))
        assert_allclose(float(value), float(expected), rtol=1e-6)


def test_dsnt_known_gaussians():
    """Golden values (reference tests/test_models.py:39-46; tests/test_dsnt.py)."""
    def hm(mu):
        return tdsnt.make_gauss(torch.tensor([[mu]]), (32, 32), 1.0)

    xy, zy, xz = tdsnt.dsnt(hm([-0.5, 0.5])), tdsnt.dsnt(hm([0.1, 0.0])), tdsnt.dsnt(hm([0.0, 0.2]))
    xyz = torch.cat([xy, 0.5 * (zy[..., 0:1] + xz[..., 1:2])], -1)
    assert_allclose(xyz.numpy(), [[[-0.5, 0.5, 0.15]]], atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """Runs on the card only: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    for b, j, h, w, sigma in [(32, 17, 32, 32, 1.0), (1, 13, 16, 24, 2.0), (1, 5, 5, 7, 1.5)]:
        _, p, mu = _heatmaps(b, j, h, w, seed=b + j)
        p_c, mu_c = torch.from_numpy(p).cuda(), torch.from_numpy(mu).cuda()
        before = dsnt_jsd_fused.launches
        coords, jsd = dsnt_jsd_fused(p_c, mu_c, sigma)
        torch.cuda.synchronize()
        assert dsnt_jsd_fused.launches == before + 1
        exp_coords, exp_jsd = dsnt_jsd_plain(p_c, mu_c, sigma)
        assert_allclose(coords.cpu().numpy(), exp_coords.cpu().numpy(), atol=1e-5)
        assert_allclose(jsd.cpu().numpy(), exp_jsd.cpu().numpy(), atol=1e-5)
    with pytest.raises(TypeError):
        dsnt_jsd_fused(p_c.double(), mu_c)
    with pytest.raises(ValueError):
        dsnt_jsd_fused(p_c.transpose(2, 3), mu_c)
