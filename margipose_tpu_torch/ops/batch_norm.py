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

``batch_norm_train_nhwc`` is the same function for a channels-last ``x``
(the bf16 train step on one card, ``train/steps.py``): on the card the
channels-last kernels (``batch_norm_train_nhwc_fwd`` / ``_bwd``), which
read and write x, y, dy and dx channels-last; ``plan_nhwc`` chooses their
channel groups and row parts. Elsewhere the same plain version, which
takes either layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from margipose_tpu_torch.ops import _build

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
    _build.KERNELS["batch_norm_train_fwd"](
        x.device, x.data_ptr(), DTYPES[x.dtype], per > 1, b, c, plane, parts, int(split),
        _ptr(weight), _ptr(bias), running_mean.data_ptr(), running_var.data_ptr(),
        num_batches_tracked.data_ptr(), -1.0 if momentum is None else float(momentum),
        float(eps), y.data_ptr(), save_mean.data_ptr(), save_invstd.data_ptr(), _ptr(work))
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
    _build.KERNELS["batch_norm_train_bwd"](
        x.device, x.data_ptr(), dy.data_ptr(), DTYPES[x.dtype], per > 1, b, c, plane, parts,
        int(split), _ptr(weight), save_mean.data_ptr(), save_invstd.data_ptr(), dx.data_ptr(),
        _ptr(dweight), _ptr(dbias), _ptr(work))
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


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` [B, C, H, W] is channels-last and not NCHW-contiguous
    (a tensor that is both, with C or H * W 1, counts as NCHW)."""
    return (x.ndim == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


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
    if not _build.takes_kernel(x.device):
        return batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                                      num_batches_tracked, momentum, eps)
    return _BatchNormTrainCuda.apply(x, weight, bias, running_mean, running_var,
                                     num_batches_tracked, momentum, eps)


# ---- channels-last: x [B, C, H, W] in NHWC memory, rows = B * H * W ----

SEGMENT_BYTES = 32            # a group's share of a row: at least one 32-byte sector
MAX_GROUP_VECTORS = 32        # a group's vectors (tc): a warp's width
SMALL_ROWS = 4096             # rows a 2-block cluster takes; more take 8
MAX_RESIDENT_BLOCKS = 96      # a resident launch's blocks: 8-block clusters cost more above
SPLIT_BLOCKS = 2 * 132        # a split launch's blocks: two for each SM...
SPLIT_GROUP_BLOCKS = 132      # ...or one for each, where one group spans the row


def vector_values_nhwc(x: torch.Tensor, *others: torch.Tensor) -> int:
    """Values a thread takes at a time in the channels-last kernels: 16
    bytes' worth where a row (C values) is a whole number of 16 bytes and
    every tensor is 16-byte aligned, else 1."""
    per = 16 // x.element_size()
    if x.shape[1] % per == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others)):
        return per
    return 1


def _pow2_at_most(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def plan_nhwc(channels: int, rows: int, width: int, tensors: int, per: int = None):
    """How a channels-last launch splits x [rows, channels] of ``width``-byte
    values, ``tensors`` of them a value (1 forward: x; 2 backward: x and
    dy), ``per`` values a thread access (16 bytes' worth by default):
    ``('cluster', tc, k)``, one launch, groups of tc vectors of a row, each
    group's rows held in the shared memory of a cluster of k blocks; or
    ``('split', tc, parts)``, three launches, each group's rows streamed by
    ``parts`` blocks and read twice.

    From the kernels' times at the train cells' shapes on an H100 (PERF.md
    §6): a cluster takes 2 blocks up to ``SMALL_ROWS`` rows and 8 above; its
    group starts at one 32-byte sector of a row and widens while the launch
    would have more than ``MAX_RESIDENT_BLOCKS`` blocks; where that group's
    rows do not fit ``MAX_SLICE_BYTES`` a block, or a thread takes single
    values (their resident kernel is the slowest), the split path, with the
    widest group (the largest power of two up to 32 vectors dividing the
    row, a row under 32 bytes whole; 16 bytes of single values) and about
    ``SPLIT_BLOCKS`` blocks (``SPLIT_GROUP_BLOCKS`` where one group spans
    the row)."""
    per = per or 16 // width
    cols = -(-channels // per)
    vector = per * width
    widest = min(MAX_GROUP_VECTORS, cols & -cols)
    if per == 1:  # single values: 16 bytes of a row, its last group's lanes past the row idle
        widest = min(MAX_GROUP_VECTORS, 16 // width)
    elif widest * vector < SEGMENT_BYTES and cols <= MAX_GROUP_VECTORS:
        widest = 1 << (cols - 1).bit_length()
    if per > 1:
        k = min(2 if rows <= SMALL_ROWS else MAX_CLUSTER, _pow2_at_most(rows))
        tc = min(widest, max(1, SEGMENT_BYTES // vector))
        while tc < widest and -(-cols // tc) * k > MAX_RESIDENT_BLOCKS:
            tc *= 2
        if -(-rows // k) * tc * vector * tensors <= MAX_SLICE_BYTES:
            return 'cluster', tc, k
    groups = -(-cols // widest)
    parts = SPLIT_GROUP_BLOCKS if groups == 1 else -(-SPLIT_BLOCKS // groups)
    return 'split', widest, max(1, min(rows, parts))


def check_input_nhwc(x: torch.Tensor) -> tuple[int, int]:
    """(rows, C) of a channels-last ``x`` the kernels take, wherever it
    lies; raises otherwise."""
    if x.dtype not in DTYPES:
        raise TypeError(f"batch_norm_train_nhwc: x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"batch_norm_train_nhwc: x must be channels-last [B, C, H, W], got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    b, c, h, w = x.shape
    rows = b * h * w
    if rows < 2:
        raise ValueError(f"batch_norm_train_nhwc: expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    if c > MAX_CHANNELS or rows >= 2 ** 31:
        raise ValueError(f"batch_norm_train_nhwc: the kernels take at most {MAX_CHANNELS} "
                         f"channels and fewer than 2^31 rows, got {tuple(x.shape)}")
    return rows, c


def _check_cuda_nhwc(x: torch.Tensor) -> tuple[int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train_nhwc: x is on {x.device}, expected a CUDA device")
    return check_input_nhwc(x)


def batch_norm_train_nhwc_fwd(x, weight, bias, running_mean, running_var, num_batches_tracked,
                              momentum, eps):
    """``batch_norm_train_fwd`` for a channels-last CUDA ``x``: y
    channels-last, the launch as ``plan_nhwc`` plans it."""
    rows, c = _check_cuda_nhwc(x)
    if (weight is None) != (bias is None):
        raise ValueError("batch_norm_train: weight and bias must both be given or both None")
    check_stats(x, weight=weight, bias=bias, running_mean=running_mean,
                running_var=running_var)
    if (num_batches_tracked.device != x.device or num_batches_tracked.dtype != torch.int64
            or num_batches_tracked.numel() != 1):
        raise ValueError("batch_norm_train: num_batches_tracked must be one int64 on "
                         f"{x.device}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    save_mean = torch.empty(c, dtype=torch.float32, device=x.device)
    save_invstd = torch.empty(c, dtype=torch.float32, device=x.device)
    per = vector_values_nhwc(x, y)
    kind, tc, parts = plan_nhwc(c, rows, x.element_size(), 1, per)
    split = kind == 'split'
    work = torch.empty((parts, c, 3), dtype=torch.float32, device=x.device) if split else None
    if momentum is None:
        num_batches_tracked.add_(1)  # the kernel reads it: the cumulative average
    _build.KERNELS["batch_norm_train_nhwc_fwd"](
        x.device, x.data_ptr(), DTYPES[x.dtype], per > 1, rows, c, tc, parts, int(split),
        _ptr(weight), _ptr(bias), running_mean.data_ptr(), running_var.data_ptr(),
        num_batches_tracked.data_ptr(), -1.0 if momentum is None else float(momentum),
        float(eps), y.data_ptr(), save_mean.data_ptr(), save_invstd.data_ptr(), _ptr(work))
    return y, save_mean, save_invstd


def batch_norm_train_nhwc_bwd(dy, x, weight, save_mean, save_invstd):
    """``batch_norm_train_bwd`` for a channels-last CUDA ``x``: dy taken in
    either layout (copied channels-last where it is not), dx
    channels-last."""
    rows, c = _check_cuda_nhwc(x)
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"batch_norm_train: dy is {dy.dtype} {tuple(dy.shape)} on {dy.device}, "
                         f"expected {x.dtype} {tuple(x.shape)} on {x.device}")
    dy = dy.contiguous(memory_format=torch.channels_last)
    check_stats(x, weight=weight, save_mean=save_mean, save_invstd=save_invstd)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dweight = dbias = None
    if weight is not None:
        dweight = torch.empty(c, dtype=torch.float32, device=x.device)
        dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    per = vector_values_nhwc(x, dy, dx)
    kind, tc, parts = plan_nhwc(c, rows, x.element_size(), 2, per)
    split = kind == 'split'
    work = (torch.empty((parts + 1, c, 2), dtype=torch.float32, device=x.device) if split
            else None)
    _build.KERNELS["batch_norm_train_nhwc_bwd"](
        x.device, x.data_ptr(), dy.data_ptr(), DTYPES[x.dtype], per > 1, rows, c, tc, parts,
        int(split), _ptr(weight), save_mean.data_ptr(), save_invstd.data_ptr(), dx.data_ptr(),
        _ptr(dweight), _ptr(dbias), _ptr(work))
    return dx, dweight, dbias


class _BatchNormTrainNhwcCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked, momentum,
                eps):
        y, save_mean, save_invstd = batch_norm_train_nhwc_fwd(
            x, weight, bias, running_mean, running_var, num_batches_tracked, momentum, eps)
        ctx.save_for_backward(x, weight, save_mean, save_invstd)  # x: relu_ rewrites y
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, save_mean, save_invstd = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_train_nhwc_bwd(dy, x, weight, save_mean, save_invstd)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None, None, None, None, None)


def batch_norm_train_nhwc(x, weight, bias, running_mean, running_var, num_batches_tracked,
                          momentum=0.1, eps=1e-5):
    """``batch_norm_train`` for a channels-last ``x``: on the card the
    channels-last kernels, y and the input's gradient channels-last;
    elsewhere the plain version."""
    if not _build.takes_kernel(x.device):
        return batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                                      num_batches_tracked, momentum, eps)
    return _BatchNormTrainNhwcCuda.apply(x, weight, bias, running_mean, running_var,
                                         num_batches_tracked, momentum, eps)
