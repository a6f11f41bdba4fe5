"""Fused DSNT soft-argmax + target-Gaussian JSD: the flagship's loss head.

Port of ``margipose_tpu/ops/pallas_dsnt.py``, grouped: ``dsnt_jsd_grouped``
takes G heatmap tensors of one shape (the flagship's 4 stages x 3 planes)
with their targets. On CUDA tensors it launches the hand-written forward
kernel in ``csrc/dsnt_jsd.cu`` once for all G groups (``dsnt_jsd_fwd``), and
its gradient launches the backward kernel of the same file once
(``dsnt_jsd_bwd``). ``dsnt_jsd_fused`` is the one-group call, with the JAX
function's signature. On CPU tensors the head runs ``dsnt_jsd_plain`` and
autograd differentiates its torch ops; ``dsnt_jsd_fwd_plain`` and
``dsnt_jsd_bwd_plain`` are the kernels' plain versions. There is no fallback
on CUDA: a tensor a kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import torch

from margipose_tpu_torch.ops import _build
from margipose_tpu_torch.ops.dsnt import (
    DIVERGENCE_EPS,
    dsnt,
    gauss_axis_coeff,
    js_reg_losses,
    make_gauss,
    normalized_linspace,
)

KERNEL = "dsnt_jsd"
MAX_GROUPS = 32  # kMaxGroups in csrc/dsnt_jsd.cu: the pointers a launch's parameters hold


def dsnt_jsd_plain(heatmaps: torch.Tensor, mu: torch.Tensor, sigma: float = 1.0):
    """``(dsnt(heatmaps), js_reg_losses(heatmaps, mu, sigma))`` with torch ops."""
    return dsnt(heatmaps), js_reg_losses(heatmaps, mu, sigma)


def _vjp_plain(heatmaps: torch.Tensor, mu: torch.Tensor, grad: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """The closed-form VJP of one group's rows with torch ops: for
    ``heatmaps`` ``[B, J, H, W]``, ``mu`` ``[B, J, 2]`` and the cotangent
    ``grad`` ``[B*J, 4]`` of the rows (ex, ey, jsd, 0), returns
    ``dp = g0 cx + g1 cy + g2 * 0.5 (ln(p + eps) - ln(m + eps))``, m = (p + q)/2."""
    b, j, h, w = heatmaps.shape
    q = make_gauss(mu.detach(), (h, w), sigma)
    m = 0.5 * (heatmaps + q)
    djsd = 0.5 * (torch.log(heatmaps + DIVERGENCE_EPS) - torch.log(m + DIVERGENCE_EPS))
    g = grad.reshape(b, j, 4, 1, 1)
    cx = normalized_linspace(w, heatmaps.dtype, heatmaps.device)
    cy = normalized_linspace(h, heatmaps.dtype, heatmaps.device)[:, None]
    return g[:, :, 0] * cx + g[:, :, 1] * cy + g[:, :, 2] * djsd


def dsnt_jsd_fwd_plain(heatmaps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                       sigma: float = 1.0) -> torch.Tensor:
    """The forward kernel's plain version: rows ``[G, B*J, 4]`` of
    (ex, ey, jsd, 0), one ``dsnt_jsd_plain`` per group."""
    rows = []
    for hm, mu in zip(heatmaps, mus, strict=True):
        coords, jsd = dsnt_jsd_plain(hm, mu, sigma)
        rows.append(torch.cat([coords, jsd[..., None], torch.zeros_like(jsd)[..., None]], -1))
    return torch.stack(rows).reshape(len(rows), -1, 4)


def dsnt_jsd_bwd_plain(heatmaps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                       grad: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """The backward kernel's plain version: for the cotangent ``grad``
    ``[G, B*J, 4]`` of the rows, ``dp`` ``[G, B, J, H, W]``. There is no
    ``mu`` cotangent: the targets are constants."""
    return torch.stack([_vjp_plain(hm, mu, g, sigma)
                        for hm, mu, g in zip(heatmaps, mus, grad, strict=True)])


@functools.cache
def _lib():
    lib = _build.load(KERNEL)
    ptrs = ctypes.POINTER(ctypes.c_uint64)
    lib.dsnt_jsd_fwd.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.dsnt_jsd_bwd.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.dsnt_jsd_log_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dsnt_jsd_fwd.restype = lib.dsnt_jsd_bwd.restype = ctypes.c_int
    lib.dsnt_jsd_log_check.restype = ctypes.c_int
    return lib


def _check_groups(heatmaps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor]) -> None:
    """Raises unless there are 1..MAX_GROUPS groups, each ``[B, J, H, W]``
    heatmaps of one shape with ``[B, J, 2]`` targets, all on one device."""
    if not 0 < len(heatmaps) <= MAX_GROUPS:
        raise ValueError(f"dsnt_jsd: {len(heatmaps)} groups, expected 1 to {MAX_GROUPS}")
    if len(mus) != len(heatmaps):
        raise ValueError(f"dsnt_jsd: {len(heatmaps)} heatmap groups but {len(mus)} targets")
    shape, device = tuple(heatmaps[0].shape), heatmaps[0].device
    if len(shape) != 4:
        raise ValueError(f"dsnt_jsd: heatmaps must be [B, J, H, W], got {shape}")
    for hm, mu in zip(heatmaps, mus):
        if tuple(hm.shape) != shape or tuple(mu.shape) != shape[:2] + (2,):
            raise ValueError(f"dsnt_jsd: groups differ: heatmaps {tuple(hm.shape)} and targets "
                             f"{tuple(mu.shape)}, expected {shape} and {shape[:2] + (2,)}")
        if hm.device != device or mu.device != device:
            raise ValueError(f"dsnt_jsd: groups on {hm.device} and {mu.device}, expected {device}")


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"dsnt_jsd: {name} is on {t.device}, expected a CUDA device")
    if t.dtype != torch.float32:
        raise TypeError(f"dsnt_jsd: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"dsnt_jsd: {name} must be contiguous")


def _pointers(heatmaps, mus):
    for hm, mu in zip(heatmaps, mus):
        _check_cuda("heatmaps", hm)
        _check_cuda("mu", mu)
    g = len(heatmaps)
    return ((ctypes.c_uint64 * g)(*(hm.data_ptr() for hm in heatmaps)),
            (ctypes.c_uint64 * g)(*(mu.data_ptr() for mu in mus)))


def dsnt_jsd_fwd(heatmaps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                 sigma: float = 1.0) -> torch.Tensor:
    """Rows ``[G, B*J, 4]`` of (ex, ey, jsd, 0) for G groups of ``[B, J, H, W]``
    heatmaps and ``[B, J, 2]`` targets: ``dsnt_jsd_fwd_plain`` on CPU
    tensors; on CUDA tensors one launch of the forward kernel on the current
    stream."""
    _check_groups(heatmaps, mus)
    hm0 = heatmaps[0]
    if hm0.device.type == "cpu":
        return dsnt_jsd_fwd_plain(heatmaps, mus, sigma)
    p_ptrs, mu_ptrs = _pointers(heatmaps, mus)
    g, (b, j, h, w) = len(heatmaps), hm0.shape
    out = torch.empty((g, b * j, 4), dtype=torch.float32, device=hm0.device)
    with torch.cuda.device(hm0.device):  # launch on the tensors' card, not the current one
        err = _lib().dsnt_jsd_fwd(p_ptrs, mu_ptrs, g, out.data_ptr(), b * j, h, w,
                                  gauss_axis_coeff(w, sigma), gauss_axis_coeff(h, sigma),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dsnt_jsd_fwd kernel launch failed: CUDA error {err}")
    dsnt_jsd_fwd.launches += 1
    return out


def dsnt_jsd_bwd(heatmaps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                 grad: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """``dp`` ``[G, B, J, H, W]`` for the cotangent ``grad`` ``[G, B*J, 4]`` of
    the rows ``dsnt_jsd_fwd`` wrote: ``dsnt_jsd_bwd_plain`` on CPU tensors; on
    CUDA tensors one launch of the backward kernel on the current stream."""
    _check_groups(heatmaps, mus)
    hm0 = heatmaps[0]
    if hm0.device.type == "cpu":
        return dsnt_jsd_bwd_plain(heatmaps, mus, grad, sigma)
    p_ptrs, mu_ptrs = _pointers(heatmaps, mus)
    g, (b, j, h, w) = len(heatmaps), hm0.shape
    _check_cuda("grad", grad)
    if grad.device != hm0.device or tuple(grad.shape) != (g, b * j, 4):
        raise ValueError(f"dsnt_jsd_bwd: grad is {tuple(grad.shape)} on {grad.device}, "
                         f"expected {(g, b * j, 4)} on {hm0.device}")
    dp = torch.empty((g, b, j, h, w), dtype=torch.float32, device=hm0.device)
    with torch.cuda.device(hm0.device):
        err = _lib().dsnt_jsd_bwd(p_ptrs, mu_ptrs, g, grad.data_ptr(), dp.data_ptr(), b * j, h,
                                  w, gauss_axis_coeff(w, sigma), gauss_axis_coeff(h, sigma),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dsnt_jsd_bwd kernel launch failed: CUDA error {err}")
    dsnt_jsd_bwd.launches += 1
    return dp


def log_normal_mismatches(device: torch.device | str = "cuda") -> int:
    """The normal, positive, finite floats x for which the kernels' fast log
    (``log_normal`` in ``csrc/dsnt_jsd.cu``) and CUDA's ``logf`` differ in any
    bit, counted on the card over all 2^32 bit patterns: 0 when the kernels'
    logs are ``logf``'s."""
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(count.device):
        err = _lib().dsnt_jsd_log_check(count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dsnt_jsd_log_check kernel launch failed: CUDA error {err}")
    return int(count.item())


class _DsntJsdCuda(torch.autograd.Function):
    """Inputs: the G targets (one list: constants, not autograd inputs), sigma,
    then the G heatmaps."""

    @staticmethod
    def forward(ctx, mus, sigma, *heatmaps):
        ctx.save_for_backward(*heatmaps)  # the softmax's backward keeps them alive anyway
        ctx.mus, ctx.sigma = mus, sigma
        return dsnt_jsd_fwd(heatmaps, mus, sigma)

    @staticmethod
    def backward(ctx, grad_rows):
        # grad_rows is the gradient of the rows' coordinate and jsd views
        dp = dsnt_jsd_bwd(ctx.saved_tensors, ctx.mus, grad_rows.contiguous(), ctx.sigma)
        return (None, None, *dp.unbind(0))  # no mu cotangent: the targets are constants


def dsnt_jsd_grouped(heatmaps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                     sigma: float = 1.0) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``dsnt_jsd_fused`` of each group, in one kernel launch on CUDA.

    Args:
      heatmaps: G (at most ``MAX_GROUPS``) [B, J, H, W] normalized heatmaps
        of one shape.
      mus: G [B, J, 2] target coordinates (constants, no gradient).
      sigma: target Gaussian standard deviation in pixels.

    Returns:
      G pairs (coords [B, J, 2], jsd [B, J]), each equal to ``dsnt_jsd_plain``.
    """
    _check_groups(heatmaps, mus)
    device = heatmaps[0].device
    if device.type == "cpu":  # js_reg_losses detaches the targets
        return [dsnt_jsd_plain(hm, mu, sigma) for hm, mu in zip(heatmaps, mus)]
    if device.type != "cuda":
        raise ValueError(f"dsnt_jsd_grouped: unsupported device {device}")
    g, b, j = len(heatmaps), *heatmaps[0].shape[:2]
    rows = _DsntJsdCuda.apply([mu.detach() for mu in mus], float(sigma), *heatmaps)
    coords = rows[..., :2].reshape(g, b, j, 2).unbind(0)
    jsd = rows[..., 2].reshape(g, b, j).unbind(0)
    return list(zip(coords, jsd))


def dsnt_jsd_fused(heatmaps: torch.Tensor, mu: torch.Tensor, sigma: float = 1.0):
    """Fused DSNT + JSD for normalized heatmaps: one group of ``dsnt_jsd_grouped``.

    Args:
      heatmaps: [B, J, H, W] normalized (post-softmax) heatmaps.
      mu: [B, J, 2] target coordinates (normalized; constants, no gradient).
      sigma: target Gaussian standard deviation in pixels.

    Returns:
      (coords [B, J, 2], jsd [B, J]), equal to ``dsnt_jsd_plain``.
    """
    return dsnt_jsd_grouped([heatmaps], [mu], sigma)[0]


dsnt_jsd_fwd.launches = 0  # forward kernel launches since the last reset
dsnt_jsd_bwd.launches = 0  # backward kernel launches since the last reset
