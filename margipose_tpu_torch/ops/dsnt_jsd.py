"""Fused DSNT soft-argmax + target-Gaussian JSD: the flagship's loss head.

Port of ``margipose_tpu/ops/pallas_dsnt.py``. On a CUDA tensor
``dsnt_jsd_fused`` launches the hand-written kernel in ``csrc/dsnt_jsd.cu``
(one launch per call); on a CPU tensor it runs ``dsnt_jsd_plain``, the same
function written with torch ops. There is no fallback on CUDA: a tensor the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from margipose_tpu_torch.ops import _build
from margipose_tpu_torch.ops.dsnt import dsnt, gauss_axis_coeff, js_reg_losses

KERNEL = "dsnt_jsd"


def dsnt_jsd_plain(heatmaps: torch.Tensor, mu: torch.Tensor, sigma: float = 1.0):
    """``(dsnt(heatmaps), js_reg_losses(heatmaps, mu, sigma))`` with torch ops."""
    return dsnt(heatmaps), js_reg_losses(heatmaps, mu, sigma)


@functools.cache
def _lib():
    lib = _build.load(KERNEL)
    fn = lib.dsnt_jsd_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    err = _lib()(heatmaps.data_ptr(), mu.data_ptr(), out.data_ptr(), b * j, h, w,
                 gauss_axis_coeff(w, sigma), gauss_axis_coeff(h, sigma), stream)
    if err != 0:
        raise RuntimeError(f"dsnt_jsd kernel launch failed: CUDA error {err}")
    dsnt_jsd_fused.launches += 1
    return out


class _DsntJsdCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heatmaps, mu, sigma):
        return launch(heatmaps, mu, sigma)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "dsnt_jsd_fused has no CUDA backward yet: the backward kernel "
            "(pallas_dsnt._bwd_kernel) comes with the training slice of the port")


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


dsnt_jsd_fused.launches = 0  # kernel launches since the last reset
