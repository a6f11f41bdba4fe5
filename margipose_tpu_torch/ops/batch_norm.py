"""Train-mode batch norm whose running variance takes in the biased batch
variance, as the JAX package's BatchNorm (flax) does.

``batch_norm_train(x, weight, bias, running_mean, running_var,
num_batches_tracked, momentum, eps)`` normalises ``x`` [B, C, H, W] by the
statistics of its batch, per channel, and updates the running statistics in
place with the batch mean and the biased batch variance (EMA factor
``momentum``, or 1 / ``num_batches_tracked`` for ``momentum`` None, after
that counter's increment). On CUDA tensors it launches the hand-written
kernels of ``csrc/batch_norm.cu``: the forward (``batch_norm_train_fwd``)
and, for the gradient, the backward (``batch_norm_train_bwd``), with x, y
and the gradients in x's dtype (float32 or bf16) and everything else in
float32. On other tensors it runs ``batch_norm_train_plain``: torch's batch
norm and a fix-up of the running variance. There is no fallback on CUDA: a
tensor the kernels do not take raises.

``plan`` chooses how a launch splits a channel, from the shape alone: a
thread-block cluster of 1-8 blocks that holds the channel's values in
shared memory, or, for a channel too large for that, two launches over
chunks (see the source's notes).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from margipose_tpu_torch.ops import _build

KERNEL = "batch_norm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                 # kThreads in csrc/batch_norm.cu
MAX_CLUSTER = 8               # kMaxCluster: the portable cluster size
MAX_SLICE_BYTES = 128 * 1024  # kMaxSliceBytes: a cluster block's values in shared memory
SLICE_BYTES = 64 * 1024       # a cluster block's slice, split further above this
MIN_SLICE_BYTES = THREADS * 16  # a vector a thread: not split below this
MIN_BLOCKS = 2 * 132          # two blocks for each of the H100's 132 SMs
CHUNK_BYTES = 32 * 1024       # a split chunk's values of x
MAX_CHANNELS = 65535          # a launch's grid rows


def keep(momentum, num_batches_tracked: torch.Tensor, running_var: torch.Tensor):
    """1 - the EMA factor of this update (after num_batches_tracked's
    increment), as torch computes it."""
    if momentum is None:  # cumulative average
        return 1.0 - 1.0 / num_batches_tracked.to(running_var.dtype)
    return 1.0 - momentum


def batch_norm_train_plain(x, weight, bias, running_mean, running_var, num_batches_tracked,
                           momentum, eps):
    """Train-mode ``nn.BatchNorm2d`` (torch's own op, which folds the
    unbiased variance into ``running_var``), then the fix-up to the biased
    one: the path of every tensor off the card.

    Both frameworks normalise with the biased batch variance; torch folds the
    unbiased one into ``running_var``, a factor n/(n-1) with n = B*H*W per
    channel. The fix-up needs no second pass over the activation: with f the
    EMA factor, torch leaves ``new = (1-f) old + f var_u``, and
    ``new - (new - (1-f) old) / n`` is ``(1-f) old + f var_u (n-1)/n``.
    """
    old = running_var.clone()
    num_batches_tracked.add_(1)
    if momentum is None:  # use cumulative moving average
        factor = 1.0 / float(num_batches_tracked)
    else:
        factor = momentum
    out = F.batch_norm(x, running_mean, running_var, weight, bias, True, factor, eps)
    n = x.numel() // x.shape[1]
    # through .data: autograd saved running_var with the batch-norm node
    # (its train-mode backward never reads it), and an in-place update of
    # the tracked tensor would fail the saved-version check
    var = running_var.data
    var.sub_((var - keep(momentum, num_batches_tracked, running_var) * old) / n)
    return out


def vector_values(x: torch.Tensor, *others: torch.Tensor) -> int:
    """Values a thread takes at a time: 16 bytes' worth where each plane
    (H * W values) is a whole number of 16 bytes and every tensor is 16-byte
    aligned, else 1."""
    per = 16 // x.element_size()
    plane = x.shape[2] * x.shape[3]
    if plane % per == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others)):
        return per
    return 1


def plan(channels: int, count: int, width: int, tensors: int, per: int = None):
    """How a launch splits each channel of ``count`` values of ``width``
    bytes, ``tensors`` of them a value (1 forward: x; 2 backward: x and dy),
    ``per`` values a thread access (16 bytes' worth by default):
    ``('cluster', k)``, one launch with k blocks a channel, each holding
    its slice in shared memory; or ``('split', chunks)``, two launches over
    chunks of ``CHUNK_BYTES`` of x. k doubles while a block's slice is over
    ``SLICE_BYTES`` or the launch has fewer than ``MIN_BLOCKS`` blocks, and
    a slice stays at least ``MIN_SLICE_BYTES``."""
    per = per or 16 // width
    vectors = count // per
    vector_bytes = per * width * tensors

    def slice_bytes(k):
        return -(-vectors // k) * vector_bytes

    k = 1
    while (k < MAX_CLUSTER and slice_bytes(2 * k) >= MIN_SLICE_BYTES
           and (slice_bytes(k) > SLICE_BYTES or channels * k < MIN_BLOCKS)):
        k *= 2
    if slice_bytes(k) <= MAX_SLICE_BYTES:
        return 'cluster', k
    return 'split', -(-vectors * per * width // CHUNK_BYTES)


@functools.cache
def _lib():
    lib = _build.load(KERNEL)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.batch_norm_train_fwd.argtypes = [ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
                                         ptr, ptr, f32, f32, ptr, ptr, ptr, ptr, ptr]
    lib.batch_norm_train_bwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr,
                                         ptr, ptr, ptr, ptr, ptr, ptr]
    lib.batch_norm_train_fwd.restype = lib.batch_norm_train_bwd.restype = ctypes.c_int
    return lib


def check_input(x: torch.Tensor) -> tuple[int, int, int]:
    """(B, C, H * W) of an ``x`` the kernels take, wherever it lies; raises
    otherwise."""
    if x.dtype not in DTYPES:
        raise TypeError(f"batch_norm_train: x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"batch_norm_train: x must be NCHW-contiguous [B, C, H, W], got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    b, c, h, w = x.shape
    count = b * h * w
    if count < 2:
        raise ValueError(f"batch_norm_train: expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    if c > MAX_CHANNELS or count >= 2 ** 31:
        raise ValueError(f"batch_norm_train: the kernels take at most {MAX_CHANNELS} channels "
                         f"and fewer than 2^31 values a channel, got {tuple(x.shape)}")
    return b, c, h * w


def _check_cuda(x: torch.Tensor) -> tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train: x is on {x.device}, expected a CUDA device")
    return check_input(x)


def check_stats(x: torch.Tensor, **tensors) -> None:
    """Raises unless each named tensor (None passes) is [C] float32,
    contiguous, on x's device."""
    c = x.shape[1]
    for name, t in tensors.items():
        if t is None:
            continue
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (c,)):
            raise ValueError(f"batch_norm_train: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected contiguous float32 ({c},) on {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def batch_norm_train_fwd(x, weight, bias, running_mean, running_var, num_batches_tracked,
                         momentum, eps):
    """(y, save_mean, save_invstd) of a CUDA ``x``: the forward kernel (one
    launch, or the split path's two) on the current stream, which also
    updates ``running_mean``, ``running_var`` and ``num_batches_tracked``
    in place."""
    b, c, plane = _check_cuda(x)
    if (weight is None) != (bias is None):
        raise ValueError("batch_norm_train: weight and bias must both be given or both None")
    check_stats(x, weight=weight, bias=bias, running_mean=running_mean,
                 running_var=running_var)
    if (num_batches_tracked.device != x.device or num_batches_tracked.dtype != torch.int64
            or num_batches_tracked.numel() != 1):
        raise ValueError("batch_norm_train: num_batches_tracked must be one int64 on "
                         f"{x.device}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    save_mean = torch.empty(c, dtype=torch.float32, device=x.device)
    save_invstd = torch.empty(c, dtype=torch.float32, device=x.device)
    per = vector_values(x, y)
    kind, parts = plan(c, b * plane, x.element_size(), 1, per)
    split = kind == 'split'
    work = torch.empty((c, parts, 3), dtype=torch.float32, device=x.device) if split else None
    if momentum is None:
        num_batches_tracked.add_(1)  # the kernel reads it: the cumulative average
    with torch.cuda.device(x.device):  # launch on the tensors' card, not the current one
        err = _lib().batch_norm_train_fwd(
            x.data_ptr(), DTYPES[x.dtype], per > 1, b, c, plane, parts, int(split),
            _ptr(weight), _ptr(bias), running_mean.data_ptr(), running_var.data_ptr(),
            num_batches_tracked.data_ptr(), -1.0 if momentum is None else float(momentum),
            float(eps), y.data_ptr(), save_mean.data_ptr(), save_invstd.data_ptr(), _ptr(work),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"batch_norm_train_fwd kernel launch failed: CUDA error {err}")
    batch_norm_train_fwd.launches += 1
    return y, save_mean, save_invstd


def batch_norm_train_bwd(dy, x, weight, save_mean, save_invstd):
    """(dx, dweight, dbias) for the cotangent ``dy`` of the y that
    ``batch_norm_train_fwd`` made from ``x``: the backward kernel (one
    launch, or the split path's two) on the current stream; dweight and
    dbias are None without a weight."""
    b, c, plane = _check_cuda(x)
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"batch_norm_train: dy is {dy.dtype} {tuple(dy.shape)} on {dy.device}, "
                         f"expected {x.dtype} {tuple(x.shape)} on {x.device}")
    dy = dy.contiguous()
    check_stats(x, weight=weight, save_mean=save_mean, save_invstd=save_invstd)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dweight = dbias = None
    if weight is not None:
        dweight = torch.empty(c, dtype=torch.float32, device=x.device)
        dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    per = vector_values(x, dy, dx)
    kind, parts = plan(c, b * plane, x.element_size(), 2, per)
    split = kind == 'split'
    work = torch.empty((c, parts, 2), dtype=torch.float32, device=x.device) if split else None
    with torch.cuda.device(x.device):
        err = _lib().batch_norm_train_bwd(
            x.data_ptr(), dy.data_ptr(), DTYPES[x.dtype], per > 1, b, c, plane, parts,
            int(split), _ptr(weight), save_mean.data_ptr(), save_invstd.data_ptr(),
            dx.data_ptr(), _ptr(dweight), _ptr(dbias), _ptr(work),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"batch_norm_train_bwd kernel launch failed: CUDA error {err}")
    batch_norm_train_bwd.launches += 1
    return dx, dweight, dbias


class _BatchNormTrainCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked, momentum,
                eps):
        y, save_mean, save_invstd = batch_norm_train_fwd(
            x, weight, bias, running_mean, running_var, num_batches_tracked, momentum, eps)
        # x, never y: the in-place ReLU after each batch norm rewrites y
        ctx.save_for_backward(x, weight, save_mean, save_invstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, save_mean, save_invstd = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_train_bwd(dy, x, weight, save_mean, save_invstd)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None, None, None, None, None)


def batch_norm_train(x, weight, bias, running_mean, running_var, num_batches_tracked,
                     momentum=0.1, eps=1e-5):
    """Train-mode batch norm of ``x`` [B, C, H, W] over its batch, per channel.

    Args:
      x: float32 or bf16 (on the card, NCHW-contiguous).
      weight, bias: [C] float32, or both None.
      running_mean, running_var: [C] float32, updated in place with the
        batch mean and the biased batch variance.
      num_batches_tracked: the module's int64 counter, incremented.
      momentum: the EMA factor, or None for the cumulative average.
      eps: added to the variance.

    Returns:
      y in x's dtype, (x - mean) / sqrt(var + eps) * weight + bias.
    """
    if x.device.type != "cuda":
        return batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                                      num_batches_tracked, momentum, eps)
    return _BatchNormTrainCuda.apply(x, weight, bias, running_mean, running_var,
                                     num_batches_tracked, momentum, eps)


batch_norm_train_fwd.launches = 0  # forward launches (a split path's two count once)
batch_norm_train_bwd.launches = 0  # backward launches (a split path's two count once)
