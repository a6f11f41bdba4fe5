"""The port's DSNT ops and fused DSNT+JSD head against the JAX package.

Inputs are made with numpy from a seed and given to both packages. The JAX
fused head runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pallas.py runs it; the port's wrappers run their plain versions on
CPU tensors. The grouped head (``dsnt_jsd_grouped``: G heatmap tensors in one
launch) is held to the JAX head group by group. The CUDA kernel itself is
compared with the plain version on the card (the ``cuda``-marked tests here,
and chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from margipose_tpu.ops.pallas_dsnt import dsnt_jsd_fused as jax_dsnt_jsd_fused
from margipose_tpu_torch.ops import launch_counts
from margipose_tpu_torch.ops.dsnt_jsd import (
    MAX_GROUPS,
    dsnt_jsd_fused,
    dsnt_jsd_fwd,
    dsnt_jsd_fwd_plain,
    dsnt_jsd_grouped,
    dsnt_jsd_plain,
    log_normal_mismatches,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

# the modules, not the functions the ops packages re-export under that name
jdsnt = importlib.import_module('margipose_tpu.ops.dsnt')
tdsnt = importlib.import_module('margipose_tpu_torch.ops.dsnt')


def _heatmaps(b, j, h, w, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, j, h, w) * 2).astype(np.float32)
    p = np.array(jdsnt.flat_softmax(jnp.asarray(logits)))
    mu = rng.uniform(-0.8, 0.8, (b, j, 2)).astype(np.float32)
    return logits, p, mu


def _groups(g, b, j, h, w, seed, planes=2):
    """G heatmap groups with targets repeating over ``planes`` tensors, as the
    model's stages share each plane's targets."""
    ps = [_heatmaps(b, j, h, w, seed + i)[1] for i in range(g)]
    mus = [_heatmaps(b, j, h, w, seed + 100 + i)[2] for i in range(planes)]
    return ps, [mus[i % planes] for i in range(g)]


GROUPED_SHAPES = [
    (2, 17, 32, 32, 1.0),  # flagship rows
    (1, 3, 16, 24, 2.0),   # non-square
    (1, 13, 8, 8, 1.0),    # prime row count
]


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


@pytest.mark.parametrize('b,j,h,w,sigma', GROUPED_SHAPES)
def test_grouped_matches_jax_pallas(b, j, h, w, sigma):
    """G = 6 groups over two planes' targets, each against JAX's head."""
    ps, mus = _groups(6, b, j, h, w, seed=b * 10 + h)
    heads = dsnt_jsd_grouped([torch.from_numpy(p) for p in ps],
                             [torch.from_numpy(mu) for mu in mus], sigma)
    assert len(heads) == 6
    for i, ((coords, jsd), p, mu) in enumerate(zip(heads, ps, mus)):
        exp_coords, exp_jsd = jax_dsnt_jsd_fused(jnp.asarray(p), jnp.asarray(mu), sigma)
        assert coords.shape == (b, j, 2) and jsd.shape == (b, j)
        assert_allclose(coords.numpy(), np.asarray(exp_coords), atol=1e-5, err_msg=f'group {i}')
        assert_allclose(jsd.numpy(), np.asarray(exp_jsd), atol=1e-5, err_msg=f'group {i}')


def test_grouped_raises_on_groups_it_does_not_take():
    ps, mus = _groups(2, 1, 3, 8, 8, seed=12)
    hms, mus = [torch.from_numpy(p) for p in ps], [torch.from_numpy(m) for m in mus]
    with pytest.raises(ValueError, match='groups differ'):
        dsnt_jsd_grouped([hms[0], hms[1][:, :2]], [mus[0], mus[1][:, :2]])
    with pytest.raises(ValueError, match='groups differ'):
        dsnt_jsd_grouped(hms, [mus[0], mus[1][..., :1]])
    with pytest.raises(ValueError, match='targets'):
        dsnt_jsd_grouped(hms, mus[:1])
    with pytest.raises(ValueError, match='groups'):
        dsnt_jsd_grouped([], [])
    with pytest.raises(ValueError, match='groups'):
        dsnt_jsd_grouped(hms[:1] * (MAX_GROUPS + 1), mus[:1] * (MAX_GROUPS + 1))
    assert len(dsnt_jsd_grouped(hms[:1] * MAX_GROUPS, mus[:1] * MAX_GROUPS)) == MAX_GROUPS


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
    """Runs on the card only: the CUDA kernel, as one-group calls, against
    its plain version, on the 32x32 layout and the generic one."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    for b, j, h, w, sigma in [(32, 17, 32, 32, 1.0), (1, 13, 16, 24, 2.0), (1, 5, 5, 7, 1.5)]:
        _, p, mu = _heatmaps(b, j, h, w, seed=b + j)
        p_c, mu_c = torch.from_numpy(p).cuda(), torch.from_numpy(mu).cuda()
        before = launch_counts()['dsnt_jsd_fwd']
        coords, jsd = dsnt_jsd_fused(p_c, mu_c, sigma)
        torch.cuda.synchronize()
        assert launch_counts()['dsnt_jsd_fwd'] == before + 1
        exp_coords, exp_jsd = dsnt_jsd_plain(p_c, mu_c, sigma)
        assert_allclose(coords.cpu().numpy(), exp_coords.cpu().numpy(), atol=1e-5)
        assert_allclose(jsd.cpu().numpy(), exp_jsd.cpu().numpy(), atol=1e-5)
    with pytest.raises(TypeError):
        dsnt_jsd_fused(p_c.double(), mu_c)
    with pytest.raises(ValueError):
        dsnt_jsd_fused(p_c.transpose(2, 3), mu_c)


@pytest.mark.cuda
@pytest.mark.parametrize('g,b,j,h,w,sigma,offset,spoil', [
    (12, 32, 17, 32, 32, 1.0, 0, False),  # the flagship's batch: 4 stages x 3 planes
    (12, 10, 17, 32, 32, 1.0, 0, False),  # the multicrop eval's 10 crops of one example
    (3, 32, 17, 32, 32, 1.0, 0, False),   # Chatterbox's batch: 1 stage x 3 planes
    (3, 1, 13, 16, 24, 2.0, 0, False),    # generic layout
    (2, 1, 13, 7, 9, 1.5, 0, False),      # H*W % 4 != 0
    (2, 2, 17, 32, 32, 1.0, 1, False),    # 32x32 from pointers off 16-byte alignment
    (2, 2, 17, 32, 32, 1.0, 0, True),     # 32x32 rows outside [0, 2): logf's own path
])
def test_cuda_grouped_kernel_matches_plain(g, b, j, h, w, sigma, offset, spoil):
    """Runs on the card only: one grouped launch against the plain rows."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    ps, mus = _groups(g, b, j, h, w, seed=g + h, planes=3)
    hms = []
    for p in ps:  # each heatmap tensor `offset` floats into its storage
        flat = torch.zeros(p.size + offset, device='cuda')
        flat[offset:] = torch.from_numpy(p.ravel()).cuda()
        hms.append(flat[offset:].view(p.shape))
    if spoil:  # one row with a value of 2.5, one with a negative value (NaN logs)
        hms[0][0, 1, 3, 5] = 2.5
        hms[1][1, 2, 30, 0] = -0.25
    mus = [torch.from_numpy(mu).cuda() for mu in mus]
    before = launch_counts()['dsnt_jsd_fwd']
    rows = dsnt_jsd_fwd(hms, mus, sigma)
    torch.cuda.synchronize()
    assert launch_counts()['dsnt_jsd_fwd'] == before + 1
    expected = dsnt_jsd_fwd_plain(hms, mus, sigma).cpu().numpy()
    assert_allclose(rows.cpu().numpy(), expected, atol=1e-5)  # NaN where the plain has NaN
    assert np.isnan(expected).any() == spoil


@pytest.mark.cuda
def test_cuda_log_normal_is_logf():
    """Runs on the card only: the kernels' branch-free log gives logf's bits
    for every normal positive float, the only arguments it is given."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    assert log_normal_mismatches() == 0


def _off_map_groups(g, b, j, seed):
    """G groups of 32x32 heatmaps whose target means lie in [-3, 3]: the
    mixed 2D/3D recipe's MPII joints that leave the crop, and any joint that
    rotation and shifts push off the map. Far off the map the target
    Gaussian underflows to zero and q = 0 / (0 + eps)."""
    ps, _ = _groups(g, b, j, 32, 32, seed=seed, planes=3)
    rng = np.random.RandomState(seed + 1)
    mus = [rng.uniform(-3, 3, (b, j, 2)).astype(np.float32) for _ in range(3)]
    return ps, [mus[i % 3] for i in range(g)]


def test_grouped_matches_jax_pallas_with_targets_off_the_map():
    ps, mus = _off_map_groups(3, 2, 17, seed=40)
    assert max(np.abs(mu).max() for mu in mus) > 2.5
    heads = dsnt_jsd_grouped([torch.from_numpy(p) for p in ps],
                             [torch.from_numpy(mu) for mu in mus], 1.0)
    for i, ((coords, jsd), p, mu) in enumerate(zip(heads, ps, mus)):
        exp_coords, exp_jsd = jax_dsnt_jsd_fused(jnp.asarray(p), jnp.asarray(mu), 1.0)
        assert np.isfinite(jsd.numpy()).all()
        assert_allclose(coords.numpy(), np.asarray(exp_coords), atol=1e-5, err_msg=f'group {i}')
        assert_allclose(jsd.numpy(), np.asarray(exp_jsd), atol=1e-5, err_msg=f'group {i}')


@pytest.mark.cuda
def test_cuda_grouped_kernel_with_targets_off_the_map():
    """Runs on the card only: the flagship's batch (12 groups of 32 x 17
    rows) with target means in [-3, 3], one launch against the plain rows;
    everything finite."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    ps, mus = _off_map_groups(12, 32, 17, seed=41)
    hms = [torch.from_numpy(p).cuda() for p in ps]
    mus = [torch.from_numpy(mu).cuda() for mu in mus]
    before = launch_counts()['dsnt_jsd_fwd']
    rows = dsnt_jsd_fwd(hms, mus, 1.0)
    torch.cuda.synchronize()
    assert launch_counts()['dsnt_jsd_fwd'] == before + 1
    rows = rows.cpu().numpy()
    assert np.isfinite(rows).all()
    assert_allclose(rows, dsnt_jsd_fwd_plain(hms, mus, 1.0).cpu().numpy(), atol=1e-5)
