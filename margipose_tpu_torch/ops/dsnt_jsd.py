"""Fused DSNT soft-argmax + target-Gaussian JSD: the flagship's loss head.

Port of ``margipose_tpu/ops/pallas_dsnt.py``. On a CUDA tensor
``dsnt_jsd_fused`` launches the hand-written forward kernel in
``csrc/dsnt_jsd.cu`` (one launch per call), and its gradient launches the
backward kernel of the same file through ``dsnt_jsd_bwd`` (one launch per
backward). On a CPU tensor ``dsnt_jsd_fused`` runs ``dsnt_jsd_plain`` and
autograd differentiates its torch ops; ``dsnt_jsd_bwd_plain`` is the
backward kernel's plain version. There is no fallback on CUDA: a tensor a
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

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


def dsnt_jsd_plain(heatmaps: torch.Tensor, mu: torch.Tensor, sigma: float = 1.0):
    """``(dsnt(heatmaps), js_reg_losses(heatmaps, mu, sigma))`` with torch ops."""
    return dsnt(heatmaps), js_reg_losses(heatmaps, mu, sigma)


def dsnt_jsd_bwd_plain(heatmaps: torch.Tensor, mu: torch.Tensor, grad: torch.Tensor,
                       sigma: float = 1.0) -> torch.Tensor:
    """The closed-form VJP of the fused rows with torch ops: for ``heatmaps``
    ``[B, J, H, W]``, ``mu`` ``[B, J, 2]`` and the cotangent ``grad``
    ``[B*J, 4]`` of the rows (ex, ey, jsd, 0), returns
    ``dp = g0 cx + g1 cy + g2 * 0.5 (ln(p + eps) - ln(m + eps))``, m = (p + q)/2.
    There is no ``mu`` cotangent: the targets are constants."""
    b, j, h, w = heatmaps.shape
    q = make_gauss(mu.detach(), (h, w), sigma)
    m = 0.5 * (heatmaps + q)
    djsd = 0.5 * (torch.log(heatmaps + DIVERGENCE_EPS) - torch.log(m + DIVERGENCE_EPS))
    g = grad.reshape(b, j, 4, 1, 1)
    cx = normalized_linspace(w, heatmaps.dtype, heatmaps.device)
    cy = normalized_linspace(h, heatmaps.dtype, heatmaps.device)[:, None]
    return g[:, :, 0] * cx + g[:, :, 1] * cy + g[:, :, 2] * djsd


@functools.cache
def _lib():
    lib = _build.load(KERNEL)
    lib.dsnt_jsd_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.dsnt_jsd_bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.dsnt_jsd_fwd.restype = lib.dsnt_jsd_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, shape) -> None:
    if t.device != device:
        raise ValueError(f"dsnt_jsd_fused: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"dsnt_jsd_fused: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"dsnt_jsd_fused: {name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dsnt_jsd_fused: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def launch(heatmaps: torch.Tensor, mu: torch.Tensor, sigma: float) -> torch.Tensor:
    """Run the CUDA kernel: ``[B, J, H, W]``, ``[B, J, 2]`` -> rows ``[B*J, 4]``
    of (ex, ey, jsd, 0), on the current stream."""
    b, j, h, w = heatmaps.shape
    _check_cuda("heatmaps", heatmaps, heatmaps.device, (b, j, h, w))
    _check_cuda("mu", mu, heatmaps.device, (b, j, 2))
    out = torch.empty((b * j, 4), dtype=torch.float32, device=heatmaps.device)
    stream = torch.cuda.current_stream(heatmaps.device).cuda_stream
    err = _lib().dsnt_jsd_fwd(heatmaps.data_ptr(), mu.data_ptr(), out.data_ptr(), b * j, h, w,
                              gauss_axis_coeff(w, sigma), gauss_axis_coeff(h, sigma), stream)
    if err != 0:
        raise RuntimeError(f"dsnt_jsd_fwd kernel launch failed: CUDA error {err}")
    dsnt_jsd_fused.launches += 1
    return out


def dsnt_jsd_bwd(heatmaps: torch.Tensor, mu: torch.Tensor, grad: torch.Tensor,
                 sigma: float = 1.0) -> torch.Tensor:
    """``dsnt_jsd_bwd_plain`` on a CPU tensor; on a CUDA tensor, one launch of
    the backward kernel on the current stream. ``grad`` is the ``[B*J, 4]``
    cotangent of the rows the forward kernel wrote."""
    if heatmaps.device.type == "cpu":
        return dsnt_jsd_bwd_plain(heatmaps, mu, grad, sigma)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"dsnt_jsd_bwd: unsupported device {heatmaps.device}")
    b, j, h, w = heatmaps.shape
    _check_cuda("heatmaps", heatmaps, heatmaps.device, (b, j, h, w))
    _check_cuda("mu", mu, heatmaps.device, (b, j, 2))
    _check_cuda("grad", grad, heatmaps.device, (b * j, 4))
    dp = torch.empty_like(heatmaps)
    stream = torch.cuda.current_stream(heatmaps.device).cuda_stream
    err = _lib().dsnt_jsd_bwd(heatmaps.data_ptr(), mu.data_ptr(), grad.data_ptr(), dp.data_ptr(),
                              b * j, h, w, gauss_axis_coeff(w, sigma), gauss_axis_coeff(h, sigma),
                              stream)
    if err != 0:
        raise RuntimeError(f"dsnt_jsd_bwd kernel launch failed: CUDA error {err}")
    dsnt_jsd_bwd.launches += 1
    return dp


class _DsntJsdCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heatmaps, mu, sigma):
        ctx.save_for_backward(heatmaps, mu)
        ctx.sigma = sigma
        return launch(heatmaps, mu, sigma)

    @staticmethod
    def backward(ctx, grad_out):
        heatmaps, mu = ctx.saved_tensors
        # grad_out is the gradient of the rows[:, :2] / rows[:, 2] slices
        dp = dsnt_jsd_bwd(heatmaps, mu, grad_out.contiguous(), ctx.sigma)
        return dp, None, None  # no mu cotangent: the targets are constants


def dsnt_jsd_fused(heatmaps: torch.Tensor, mu: torch.Tensor, sigma: float = 1.0):
    """Fused DSNT + JSD for normalized heatmaps.

    Args:
      heatmaps: [B, J, H, W] normalized (post-softmax) heatmaps.
      mu: [B, J, 2] target coordinates (normalized; constants, no gradient).
      sigma: target Gaussian standard deviation in pixels.

    Returns:
      (coords [B, J, 2], jsd [B, J]), equal to ``dsnt_jsd_plain``.
    """
    mu = mu.detach()
    if heatmaps.device.type == "cpu":
        return dsnt_jsd_plain(heatmaps, mu, sigma)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"dsnt_jsd_fused: unsupported device {heatmaps.device}")
    b, j = heatmaps.shape[:2]
    rows = _DsntJsdCuda.apply(heatmaps, mu, float(sigma))
    return rows[:, :2].reshape(b, j, 2), rows[:, 2].reshape(b, j)


dsnt_jsd_fused.launches = 0  # forward kernel launches since the last reset
dsnt_jsd_bwd.launches = 0  # backward kernel launches since the last reset
