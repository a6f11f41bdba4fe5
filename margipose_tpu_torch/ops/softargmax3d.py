"""Volumetric soft-argmax: the integral model's head (Sun et al., Integral
Human Pose Regression, arXiv:1711.08229).

``softargmax3d(logits, depth)`` reads ``logits`` ``[B, J * D, H, W]`` as J
volumes ``[D, H, W]`` a row (channel ``j * D + d``), takes a softmax over
each whole volume and returns the expected voxel centre ``[B, J, 3]`` (x
along W, y along H, z along D) in float32, on the ``normalized_linspace``
grid of the port's other heads. On CUDA tensors it launches the hand-written
forward kernel of ``csrc/softargmax3d.cu`` (``softargmax3d_fwd``), and its
gradient the backward kernel of the same file (``softargmax3d_bwd``):
float32 or bf16 logits, accumulated in float32, the gradient in the logits'
dtype. On CPU tensors it runs ``softargmax3d_plain`` and autograd
differentiates its torch ops;
``softargmax3d_fwd_plain`` and ``softargmax3d_bwd_plain`` are the kernels'
plain versions. There is no fallback on CUDA: a tensor the kernels do not
take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from margipose_tpu_torch.ops import _build
from margipose_tpu_torch.ops.dsnt import normalized_linspace

KERNEL = "softargmax3d"
VEC = 8  # kVec in csrc/softargmax3d.cu: a thread's elements at a time, consecutive along W
MAX_ROWS = 65535  # a launch's grid rows
LOG2E = math.log2(math.e)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shape(logits: torch.Tensor, depth: int) -> tuple[int, int, int, int, int]:
    """(B, J, D, H, W) of ``logits`` [B, J * D, H, W]; raises on another shape."""
    if logits.ndim != 4 or depth < 1 or logits.shape[1] % depth != 0:
        raise ValueError(f"softargmax3d: logits must be [B, J * {depth}, H, W], "
                         f"got {tuple(logits.shape)}")
    b, c, h, w = logits.shape
    return b, c // depth, depth, h, w


def _centres(d: int, h: int, w: int, device) -> tuple[torch.Tensor, ...]:
    return tuple(normalized_linspace(n, torch.float32, device) for n in (w, h, d))


def _expectations(p: torch.Tensor) -> torch.Tensor:
    """(E[x], E[y], E[z]) [..., 3] of normalised volumes ``p`` [..., D, H, W],
    by the marginal sums the paper takes."""
    cx, cy, cz = _centres(*p.shape[-3:], p.device)
    return torch.stack([(p.sum((-3, -2)) * cx).sum(-1), (p.sum((-3, -1)) * cy).sum(-1),
                        (p.sum((-2, -1)) * cz).sum(-1)], -1)


def softargmax3d_plain(logits: torch.Tensor, depth: int) -> torch.Tensor:
    """``softargmax3d`` with torch ops, in float32: the CPU's path, which
    autograd differentiates."""
    b, j, d, h, w = _shape(logits, depth)
    p = logits.reshape(b, j, d * h * w).float().softmax(-1)
    return _expectations(p.view(b, j, d, h, w))


def softargmax3d_fwd_plain(logits: torch.Tensor, depth: int):
    """The forward kernel's plain version: (xyz [B, J, 3], stats [B * J, 2]),
    stats the row's (m, s), m = max l log2(e) and s = sum 2^(l log2(e) - m)."""
    b, j, d, h, w = _shape(logits, depth)
    t = logits.reshape(b * j, d * h * w).float() * LOG2E
    m = t.amax(-1, keepdim=True)
    e = torch.exp2(t - m)
    s = e.sum(-1, keepdim=True)
    xyz = _expectations((e / s).view(b, j, d, h, w))
    return xyz, torch.cat([m, s], -1)


def softargmax3d_bwd_plain(logits: torch.Tensor, depth: int, xyz: torch.Tensor,
                           stats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The backward kernel's plain version, in closed form: for the
    cotangent ``grad`` [B, J, 3] of ``xyz``, dl = p sum_a g_a (c_a - E_a),
    p = 2^(l log2(e) - m) / s from the forward's ``stats``; [B, J * D, H, W]
    in the logits' dtype."""
    b, j, d, h, w = _shape(logits, depth)
    t = logits.reshape(b * j, d, h, w).float() * LOG2E
    m, s = (x.view(b * j, 1, 1, 1) for x in stats.float().unbind(-1))
    p = torch.exp2(t - m) / s
    g, e = grad.float().reshape(b * j, 3, 1, 1, 1), xyz.float().reshape(b * j, 3, 1, 1, 1)
    cx, cy, cz = _centres(d, h, w, logits.device)
    coeff = (g[:, 0] * (cx - e[:, 0]) + g[:, 1] * (cy[:, None] - e[:, 1])
             + g[:, 2] * (cz[:, None, None] - e[:, 2]))
    return (p * coeff).reshape(logits.shape).to(logits.dtype)


@functools.cache
def _lib():
    lib = _build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.softargmax3d_fwd.argtypes = [ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.softargmax3d_bwd.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.softargmax3d_fwd.restype = lib.softargmax3d_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(logits: torch.Tensor, depth: int) -> tuple[int, int, int, int, int]:
    """``_shape`` of CUDA ``logits`` the kernels take; raises otherwise."""
    shape = _shape(logits, depth)
    b, j, d, h, w = shape
    if logits.device.type != "cuda":
        raise ValueError(f"softargmax3d: logits are on {logits.device}, expected a CUDA device")
    if logits.dtype not in DTYPES:
        raise TypeError(f"softargmax3d: logits must be float32 or bfloat16, got {logits.dtype}")
    if not logits.is_contiguous() or logits.data_ptr() % 16 != 0:
        raise ValueError("softargmax3d: logits must be contiguous and 16-byte aligned")
    if w % VEC != 0 or not 0 < b * j <= MAX_ROWS or d * h * w >= 2 ** 31:
        raise ValueError(f"softargmax3d: the kernels take W a multiple of {VEC}, 1 to "
                         f"{MAX_ROWS} volumes and fewer than 2^31 voxels a volume, got "
                         f"{tuple(logits.shape)} with D = {depth}")
    return shape


def softargmax3d_fwd(logits: torch.Tensor, depth: int):
    """(xyz [B, J, 3], stats [B * J, 2]), float32: ``softargmax3d_fwd_plain``
    on CPU tensors; on CUDA tensors one launch of the forward kernel on the
    current stream."""
    if logits.device.type == "cpu":
        return softargmax3d_fwd_plain(logits, depth)
    b, j, d, h, w = _check_cuda(logits, depth)
    xyz = torch.empty((b, j, 3), dtype=torch.float32, device=logits.device)
    stats = torch.empty((b * j, 2), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):  # launch on the tensors' card, not the current one
        err = _lib().softargmax3d_fwd(logits.data_ptr(), DTYPES[logits.dtype], b * j, d, h, w,
                                      xyz.data_ptr(), stats.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"softargmax3d_fwd kernel launch failed: CUDA error {err}")
    softargmax3d_fwd.launches += 1
    return xyz, stats


def softargmax3d_bwd(logits: torch.Tensor, depth: int, xyz: torch.Tensor, stats: torch.Tensor,
                     grad: torch.Tensor) -> torch.Tensor:
    """The logits' gradient for the cotangent ``grad`` [B, J, 3] of the
    ``xyz`` that ``softargmax3d_fwd`` wrote with ``stats``:
    ``softargmax3d_bwd_plain`` on CPU tensors; on CUDA tensors one launch of
    the backward kernel on the current stream."""
    if logits.device.type == "cpu":
        return softargmax3d_bwd_plain(logits, depth, xyz, stats, grad)
    b, j, d, h, w = _check_cuda(logits, depth)
    grad = grad.float().contiguous()
    for name, t, shape in (("xyz", xyz, (b, j, 3)), ("stats", stats, (b * j, 2)),
                           ("grad", grad, (b, j, 3))):
        if (t.device != logits.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"softargmax3d_bwd: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected contiguous float32 {shape} on "
                             f"{logits.device}")
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    with torch.cuda.device(logits.device):
        err = _lib().softargmax3d_bwd(logits.data_ptr(), DTYPES[logits.dtype], xyz.data_ptr(),
                                      stats.data_ptr(), grad.data_ptr(), dlogits.data_ptr(),
                                      b * j, d, h, w, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"softargmax3d_bwd kernel launch failed: CUDA error {err}")
    softargmax3d_bwd.launches += 1
    return dlogits


class _SoftArgmax3dCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, depth):
        xyz, stats = softargmax3d_fwd(logits, depth)
        ctx.save_for_backward(logits, xyz, stats)
        ctx.depth = depth
        return xyz

    @staticmethod
    def backward(ctx, grad):
        logits, xyz, stats = ctx.saved_tensors
        return softargmax3d_bwd(logits, ctx.depth, xyz, stats, grad), None


def softargmax3d(logits: torch.Tensor, depth: int) -> torch.Tensor:
    """The expected voxel centre of each joint's volume.

    Args:
      logits: [B, J * D, H, W] float32 or bf16; channel j * D + d is depth
        slice d of joint j.
      depth: D.

    Returns:
      xyz [B, J, 3] float32: (x, y, z) = the expectations of the centres
      ``normalized_linspace`` gives along W, H and D, under a softmax over
      each joint's D * H * W logits.
    """
    if logits.device.type == "cpu":
        return softargmax3d_plain(logits, depth)
    if logits.device.type != "cuda":
        raise ValueError(f"softargmax3d: unsupported device {logits.device}")
    return _SoftArgmax3dCuda.apply(logits, depth)


softargmax3d_fwd.launches = 0  # forward kernel launches since the last reset
softargmax3d_bwd.launches = 0  # backward kernel launches since the last reset
