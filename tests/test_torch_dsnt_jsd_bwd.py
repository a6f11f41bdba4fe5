"""The fused DSNT+JSD head's gradient against the JAX package's.

``dsnt_jsd_bwd_plain`` (the plain version of the grouped CUDA backward
kernel) and CPU autograd through ``dsnt_jsd_fused`` and ``dsnt_jsd_grouped``
are held to the VJP of ``margipose_tpu.ops.pallas_dsnt.dsnt_jsd_fused``,
whose Pallas backward runs in interpret mode on the CPU as in
tests/test_pallas.py, group by group. Inputs are made with numpy from a seed.
The CUDA kernel itself is compared with its plain version on the card (the
``cuda``-marked tests and chip_smoke.py).
Tolerance: atol 1e-4 on gradients, as tests/test_pallas.py holds the Pallas
gradients to the jnp ones; both sides are float32. The grouped cases hold
atol 1e-5.
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
    dsnt_jsd_bwd,
    dsnt_jsd_bwd_plain,
    dsnt_jsd_fused,
    dsnt_jsd_grouped,
    dsnt_jsd_plain,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

jdsnt = importlib.import_module('margipose_tpu.ops.dsnt')
tdsnt = importlib.import_module('margipose_tpu_torch.ops.dsnt')

SHAPES = [
    (2, 17, 32, 32, 1.0),  # flagship rows
    (1, 13, 16, 24, 2.0),  # non-square, prime row count
]


def _inputs(b, j, h, w, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, j, h, w) * 2).astype(np.float32)
    p = np.array(jdsnt.flat_softmax(jnp.asarray(logits)))
    mu = rng.uniform(-0.8, 0.8, (b, j, 2)).astype(np.float32)
    grad = rng.randn(b * j, 4).astype(np.float32)
    return logits, p, mu, grad


def _jax_vjp(p, mu, grad, sigma):
    b, j = p.shape[:2]
    _, vjp = jax.vjp(lambda x: jax_dsnt_jsd_fused(x, jnp.asarray(mu), sigma), jnp.asarray(p))
    (dp,) = vjp((jnp.asarray(grad[:, :2].reshape(b, j, 2)), jnp.asarray(grad[:, 2].reshape(b, j))))
    return np.asarray(dp)


@pytest.mark.parametrize('b,j,h,w,sigma', SHAPES)
def test_plain_backward_matches_jax_vjp(b, j, h, w, sigma):
    _, p, mu, grad = _inputs(b, j, h, w, seed=b * 100 + h)
    expected = _jax_vjp(p, mu, grad, sigma)
    args = ([torch.from_numpy(p)], [torch.from_numpy(mu)], torch.from_numpy(grad)[None], sigma)
    got = dsnt_jsd_bwd_plain(*args)
    assert got.shape == (1, b, j, h, w)
    assert_allclose(got[0].numpy(), expected, atol=1e-4)
    # the wrapper takes the plain version for a CPU tensor, and counts no launch
    before = launch_counts()['dsnt_jsd_bwd']
    wrapped = dsnt_jsd_bwd(*args)
    assert launch_counts()['dsnt_jsd_bwd'] == before
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize('b,j,h,w,sigma', SHAPES + [(1, 13, 8, 8, 1.0)])
def test_grouped_plain_backward_matches_jax_vjp(b, j, h, w, sigma):
    """G = 6 groups over two planes' targets, each against jax.vjp."""
    groups = [_inputs(b, j, h, w, seed=b * 100 + h + i) for i in range(6)]
    mus = [groups[i % 2][2] for i in range(6)]
    ps = [g[1] for g in groups]
    grad = np.stack([g[3] for g in groups])
    got = dsnt_jsd_bwd_plain([torch.from_numpy(p) for p in ps],
                             [torch.from_numpy(mu) for mu in mus], torch.from_numpy(grad), sigma)
    assert got.shape == (6, b, j, h, w)
    for i in range(6):
        assert_allclose(got[i].numpy(), _jax_vjp(ps[i], mus[i], grad[i], sigma), atol=1e-5,
                        err_msg=f'group {i}')


def test_plain_backward_ignores_the_fourth_column():
    _, p, mu, grad = _inputs(1, 3, 8, 8, seed=5)
    other = grad.copy()
    other[:, 3] = 1e3
    a, c = (dsnt_jsd_bwd_plain([torch.from_numpy(p)], [torch.from_numpy(mu)],
                               torch.from_numpy(g)[None])
            for g in (grad, other))
    assert torch.equal(a, c)


@pytest.mark.parametrize('b,j,h,w,sigma', SHAPES)
def test_cpu_autograd_matches_jax_grad(b, j, h, w, sigma):
    _, p, mu, grad = _inputs(b, j, h, w, seed=b * 10 + w)
    weights = grad.reshape(b, j, 4)

    def jax_loss(x):
        coords, jsd = jax_dsnt_jsd_fused(x, jnp.asarray(mu), sigma)
        return jnp.sum(coords * weights[..., :2]) + jnp.sum(jsd * weights[..., 2])

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(p)))
    p_t = torch.from_numpy(p).requires_grad_()
    coords, jsd = dsnt_jsd_fused(p_t, torch.from_numpy(mu), sigma)
    w_t = torch.from_numpy(weights)
    ((coords * w_t[..., :2]).sum() + (jsd * w_t[..., 2]).sum()).backward()
    assert_allclose(p_t.grad.numpy(), expected, atol=1e-4)


@pytest.mark.parametrize('b,j,h,w,sigma', SHAPES + [(1, 13, 8, 8, 1.0)])
def test_grouped_gradient_through_softmax_matches_jax(b, j, h, w, sigma):
    """flat_softmax -> dsnt_jsd_grouped over G = 6 groups (two planes'
    targets) against jax.grad of the same loss through JAX's head; the
    targets get no gradient."""
    groups = [_inputs(b, j, h, w, seed=b * 10 + w + i) for i in range(6)]
    logits = [g[0] for g in groups]
    mus = [groups[i % 2][2] for i in range(6)]
    weights = [g[3].reshape(b, j, 4) for g in groups]

    def loss(heads, xp):
        return sum(xp.sum(c * wt[..., :2]) + xp.sum(d * wt[..., 2])
                   for (c, d), wt in zip(heads, weights))

    def jax_loss(lgs):
        return loss([jax_dsnt_jsd_fused(jdsnt.flat_softmax(lg), jnp.asarray(mu), sigma)
                     for lg, mu in zip(lgs, mus)], jnp)

    expected = jax.grad(jax_loss)([jnp.asarray(lg) for lg in logits])
    lgs = [torch.from_numpy(lg).requires_grad_() for lg in logits]
    mu_ts = [torch.from_numpy(mu).requires_grad_() for mu in mus[:2]]
    heads = dsnt_jsd_grouped([tdsnt.flat_softmax(lg) for lg in lgs],
                             [mu_ts[i % 2] for i in range(6)], sigma)
    weights = [torch.from_numpy(wt) for wt in weights]
    grads = torch.autograd.grad(loss(heads, torch), lgs + mu_ts, allow_unused=True)
    assert grads[6:] == (None, None)
    for i in range(6):
        assert_allclose(grads[i].numpy(), np.asarray(expected[i]), atol=1e-5,
                        err_msg=f'group {i}')


def test_gradient_through_softmax_matches_jax_and_mu_gets_none():
    logits, _, mu, _ = _inputs(2, 17, 32, 32, seed=3)

    def jax_loss(lg, m):
        coords, jsd = jax_dsnt_jsd_fused(jdsnt.flat_softmax(lg), m)
        return jnp.sum(coords ** 2) + jnp.sum(jsd)

    g_logits, g_mu = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(mu))
    np.testing.assert_array_equal(np.asarray(g_mu), 0.0)  # no mu cotangent, by contract
    lg = torch.from_numpy(logits).requires_grad_()
    mu_t = torch.from_numpy(mu).requires_grad_()
    coords, jsd = dsnt_jsd_fused(tdsnt.flat_softmax(lg), mu_t)
    d_logits, d_mu = torch.autograd.grad((coords ** 2).sum() + jsd.sum(), (lg, mu_t),
                                         allow_unused=True)
    assert d_mu is None
    assert_allclose(d_logits.numpy(), np.asarray(g_logits), atol=1e-4)


@pytest.mark.cuda
def test_cuda_backward_matches_plain():
    """On the card: the backward kernel as one-group calls against its plain
    version, and autograd through the fused head against autograd through
    the plain one."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    for b, j, h, w, sigma in SHAPES + [(32, 17, 32, 32, 1.0), (1, 5, 5, 7, 1.5)]:
        logits, p, mu, grad = _inputs(b, j, h, w, seed=b + j)
        p_c, mu_c, g_c = (torch.from_numpy(a).cuda() for a in (p, mu, grad))
        args = ([p_c], [mu_c], g_c[None], sigma)
        before = launch_counts()['dsnt_jsd_bwd']
        dp = dsnt_jsd_bwd(*args)
        torch.cuda.synchronize()
        assert launch_counts()['dsnt_jsd_bwd'] == before + 1
        assert_allclose(dp.cpu().numpy(), dsnt_jsd_bwd_plain(*args).cpu().numpy(), atol=1e-5)
        grads = []
        for head in (dsnt_jsd_fused, dsnt_jsd_plain):
            lg = torch.from_numpy(logits).cuda().requires_grad_()
            coords, jsd = head(tdsnt.flat_softmax(lg), mu_c, sigma)
            grads.append(torch.autograd.grad((coords ** 2).sum() + jsd.sum(), lg)[0].cpu())
        assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        dsnt_jsd_bwd([p_c], [mu_c], g_c[None, :, :3].contiguous(), sigma)


@pytest.mark.cuda
@pytest.mark.parametrize('g,b,j,h,w,sigma,spoil', [
    (12, 32, 17, 32, 32, 1.0, False),  # the flagship's batch: 4 stages x 3 planes
    (12, 10, 17, 32, 32, 1.0, False),  # the multicrop eval's 10 crops of one example
    (3, 32, 17, 32, 32, 1.0, False),   # Chatterbox's batch: 1 stage x 3 planes
    (3, 1, 13, 16, 24, 2.0, False),    # generic layout
    (2, 1, 13, 7, 9, 1.5, False),      # H*W % 4 != 0
    (2, 2, 17, 32, 32, 1.0, True),     # 32x32 rows outside [0, 2): logf's own path
])
def test_cuda_grouped_backward_matches_plain(g, b, j, h, w, sigma, spoil):
    """On the card: one grouped backward launch against the plain version,
    and autograd through flat_softmax -> dsnt_jsd_grouped (one launch each
    way) against autograd through the plain head, with no target gradient."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    groups = [_inputs(b, j, h, w, seed=g + h + i) for i in range(g)]
    ps = [torch.from_numpy(x[1]).cuda() for x in groups]
    mus = [torch.from_numpy(groups[i % 3][2]).cuda() for i in range(g)]
    grad = torch.from_numpy(np.stack([x[3] for x in groups])).cuda()
    if spoil:  # one row with a value of 2.5, one with a negative value (NaN logs)
        ps[0][0, 1, 3, 5] = 2.5
        ps[1][1, 2, 30, 0] = -0.25
    before = launch_counts()['dsnt_jsd_bwd']
    dp = dsnt_jsd_bwd(ps, mus, grad, sigma)
    torch.cuda.synchronize()
    assert launch_counts()['dsnt_jsd_bwd'] == before + 1
    expected = dsnt_jsd_bwd_plain(ps, mus, grad, sigma).cpu().numpy()
    assert_allclose(dp.cpu().numpy(), expected, atol=1e-5)  # NaN where the plain has NaN
    assert np.isnan(expected).any() == spoil
    if spoil:
        return
    lgs = [torch.from_numpy(x[0]).cuda().requires_grad_() for x in groups]
    mu_ts = [mu.clone().requires_grad_() for mu in mus]
    results = []
    for head in (dsnt_jsd_grouped, lambda hms, ms, s: [dsnt_jsd_plain(*a, s) for a in zip(hms, ms)]):
        heads = head([tdsnt.flat_softmax(lg) for lg in lgs], mu_ts, sigma)
        loss = sum((c ** 2).sum() + d.sum() for c, d in heads)
        results.append(torch.autograd.grad(loss, lgs + mu_ts, allow_unused=True))
    assert all(d is None for d in results[0][g:])
    for got, want in zip(results[0][:g], results[1][:g]):
        assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)


def _mixed_recipe_rows(g, b, j, seed):
    """G groups of 32x32 rows as the mixed 2D/3D recipe gives them: target
    means in [-3, 3] (joints off the map), and in the zy/xz groups (i % 3 !=
    0) the rows of every third example with an upstream gradient of exactly
    zero (an MPII example, whose zy/xz losses are dropped)."""
    groups = [_inputs(b, j, 32, 32, seed=seed + i) for i in range(g)]
    rng = np.random.RandomState(seed)
    mus = [rng.uniform(-3, 3, (b, j, 2)).astype(np.float32) for _ in range(3)]
    grad = np.stack([x[3] for x in groups])
    two_d = (np.arange(b * j) // j) % 3 == 1
    for i in range(g):
        if i % 3:
            grad[i, two_d] = 0
    return groups, [mus[i % 3] for i in range(g)], grad, two_d


def test_plain_backward_matches_jax_vjp_on_mixed_recipe_rows():
    groups, mus, grad, two_d = _mixed_recipe_rows(3, 3, 17, seed=50)
    ps = [x[1] for x in groups]
    got = dsnt_jsd_bwd_plain([torch.from_numpy(p) for p in ps],
                             [torch.from_numpy(mu) for mu in mus], torch.from_numpy(grad), 1.0)
    for i in range(3):
        assert_allclose(got[i].numpy(), _jax_vjp(ps[i], mus[i], grad[i], 1.0), atol=1e-5,
                        err_msg=f'group {i}')
    assert np.isfinite(got.numpy()).all()
    assert not got[1].reshape(-1, 32 * 32)[two_d].any()  # zero gradient in, zero out


@pytest.mark.cuda
def test_cuda_grouped_backward_on_mixed_recipe_rows():
    """On the card: the flagship's batch (12 groups of 32 x 17 rows) with
    target means in [-3, 3] and a third of the zy/xz rows with an upstream
    gradient of exactly zero, one launch against the plain version; those
    rows' gradients are exactly zero and everything is finite."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    groups, mus, grad, two_d = _mixed_recipe_rows(12, 32, 17, seed=51)
    ps = [torch.from_numpy(x[1]).cuda() for x in groups]
    mus = [torch.from_numpy(mu).cuda() for mu in mus]
    grad = torch.from_numpy(grad).cuda()
    before = launch_counts()['dsnt_jsd_bwd']
    dp = dsnt_jsd_bwd(ps, mus, grad, 1.0)
    torch.cuda.synchronize()
    assert launch_counts()['dsnt_jsd_bwd'] == before + 1
    dp = dp.cpu().numpy()
    assert np.isfinite(dp).all()
    assert_allclose(dp, dsnt_jsd_bwd_plain(ps, mus, grad, 1.0).cpu().numpy(), atol=1e-5)
    for i in range(1, 12, 3):
        assert not dp[i].reshape(-1, 32 * 32)[two_d].any()
