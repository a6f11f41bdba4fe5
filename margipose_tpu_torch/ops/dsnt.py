"""Differentiable spatial-to-numerical (DSNT) operations in PyTorch.

Counterparts of ``margipose_tpu/ops/dsnt.py`` (reference:
src/margipose/dsntnn.py:12-232). Heatmaps are ``[batch, channels, *spatial]``
with the spatial dimensions trailing, and coordinates are ordered
``(x, y, ...)``: x indexes the *last* spatial axis.
"""

from __future__ import annotations

import torch

# Shared by every Gaussian/divergence implementation in the port (this
# module and the CUDA kernel in ops/dsnt_jsd.py), as in the JAX package.
DIVERGENCE_EPS = 1e-24
_EPS = DIVERGENCE_EPS


def gauss_axis_coeff(size, sigma):
    """Coefficient k of one separable-Gaussian axis factor
    ``exp(k * (coord - mu)**2)`` over a ``normalized_linspace(size)`` grid
    with ``sigma`` in pixels: ``k = -0.5 * (size / (2*sigma))**2``
    (reference: src/margipose/dsntnn.py:178-183)."""
    return -0.5 * (size / (2.0 * sigma)) ** 2


def normalized_linspace(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Values in (-1, 1) at the centre of each of ``length`` cells.

    For ``length=4``: ``[-0.75, -0.25, 0.25, 0.75]``
    (reference: src/margipose/dsntnn.py:12-36).
    """
    first = -(length - 1.0) / length
    return torch.arange(length, dtype=dtype, device=device) * (2.0 / length) + first


def _coord_expectation(heatmaps: torch.Tensor, axis: int) -> torch.Tensor:
    coords = normalized_linspace(heatmaps.shape[axis], heatmaps.dtype, heatmaps.device)
    shape = (-1,) + (1,) * (heatmaps.ndim - axis - 1)
    return (heatmaps * coords.reshape(shape)).sum(dim=tuple(range(2, heatmaps.ndim)))


def dsnt(heatmaps: torch.Tensor) -> torch.Tensor:
    """Soft-argmax of normalized heatmaps: ``[B, C, *spatial] -> [B, C, n]``,
    coordinates ordered (x, y, ...) (reference: src/margipose/dsntnn.py:84-96)."""
    axes = reversed(range(2, heatmaps.ndim))
    return torch.stack([_coord_expectation(heatmaps, a) for a in axes], dim=-1)


def flat_softmax(inp: torch.Tensor) -> torch.Tensor:
    """Softmax jointly over all dims but the first two
    (reference: src/margipose/dsntnn.py:124-130)."""
    b, c = inp.shape[:2]
    return inp.reshape(b, c, -1).softmax(-1).reshape(inp.shape)


def euclidean_losses(actual: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-point Euclidean distance, ``[..., L, D] -> [..., L]``
    (reference: src/margipose/dsntnn.py:133-151)."""
    assert actual.shape == target.shape, "input tensors must have the same size"
    return ((actual - target) ** 2).sum(-1).sqrt()


def average_loss(losses: torch.Tensor, mask: torch.Tensor | None = None,
                 distributed: bool = False) -> torch.Tensor:
    """Masked mean of per-location losses; the denominator is clipped at 1
    so an all-masked batch gives 0 (reference: src/margipose/dsntnn.py:99-121).

    ``distributed``: all-reduce the numerator and the denominator over the
    active process group, so the result is the masked mean over the GLOBAL
    batch, as the JAX package psums both under shard_map. The numerator's
    all-reduce is differentiable: its backward sums the processes'
    gradients, which DistributedDataParallel's averaging then divides back,
    so the gradient is the global mean's even when the processes hold
    different numbers of unmasked joints."""
    if mask is None:
        num = losses.sum()
        denom = torch.tensor(max(float(losses.numel()), 1.0), dtype=losses.dtype,
                             device=losses.device)
    else:
        assert mask.shape == losses.shape, "mask must be the same size as losses"
        num = (losses * mask).sum()
        denom = mask.sum()
    if distributed:
        from margipose_tpu_torch.parallel.mesh import all_reduce_sum

        num = all_reduce_sum(num)
        denom = all_reduce_sum(denom.detach())
    if mask is not None:
        denom = denom.clamp(min=1.0)
    return num / denom


def make_gauss(means: torch.Tensor, size, sigma, normalize: bool = True) -> torch.Tensor:
    """Separable Gaussians: ``size`` is ``[..., height, width]`` in pixels,
    ``means`` ``[..., n]`` ordered (x, y, ...) in normalized coordinates
    (reference: src/margipose/dsntnn.py:154-195)."""
    n = len(size)
    batch_shape = tuple(means.shape[:-1])
    gauss = torch.ones(batch_shape + tuple(size), dtype=means.dtype, device=means.device)
    for i, s in enumerate(reversed(size)):  # i=0 -> x -> last size dim
        coords = normalized_linspace(s, means.dtype, means.device)
        dist = (coords - means[..., i:i + 1]) ** 2
        factor = torch.exp(dist * gauss_axis_coeff(s, sigma))
        gauss = gauss * factor.reshape(batch_shape + (1,) * (n - 1 - i) + (s,) + (1,) * i)
    if not normalize:
        return gauss
    return gauss / (gauss.sum(dim=tuple(range(-n, 0)), keepdim=True) + _EPS)


def _kl(p: torch.Tensor, q: torch.Tensor, ndims: int) -> torch.Tensor:
    unsummed = p * (torch.log(p + _EPS) - torch.log(q + _EPS))
    return unsummed.sum(dim=tuple(range(-ndims, 0)))


def _js(p: torch.Tensor, q: torch.Tensor, ndims: int) -> torch.Tensor:
    m = 0.5 * (p + q)
    return 0.5 * _kl(p, m, ndims) + 0.5 * _kl(q, m, ndims)


def js_reg_losses(heatmaps: torch.Tensor, mu_t: torch.Tensor, sigma_t) -> torch.Tensor:
    """Jensen-Shannon divergence between heatmaps and target Gaussians
    (reference: src/margipose/dsntnn.py:220-232). The target coordinates are
    constants: no gradient reaches ``mu_t``."""
    mu_t = mu_t.detach()
    ndims = mu_t.shape[-1]
    assert heatmaps.ndim == ndims + 2, f"expected heatmaps to be a {ndims + 2}D tensor"
    gauss = make_gauss(mu_t, heatmaps.shape[2:], sigma_t)
    return _js(heatmaps, gauss, ndims)
