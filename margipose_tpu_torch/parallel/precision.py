"""Mixed-precision policy: bf16 convolutions under ``torch.autocast``.

Counterpart of ``margipose_tpu/parallel/precision.py``, with the same policy:

  * **master parameters and optimiser state stay float32**: autocast casts
    copies of the weights inside each convolution, so gradients and updates
    are float32;
  * **batch-norm running statistics stay float32**: autocast leaves
    ``batch_norm`` alone, and torch's batch norm takes a bf16 input with
    float32 weights and statistics, computes its statistics in float32 and
    returns bf16 (as flax's ``BatchNorm(dtype=bf16)`` does);
  * **softmax / DSNT / losses stay float32**: the model casts each column's
    output to float32 before ``flat_softmax``
    (``models/margipose.MargiPoseModelInner``), so the loss head and its CUDA
    kernels see float32 only.

Float32 with TF32 off is the checkpoint-parity mode and the default.
"""

from __future__ import annotations

import contextlib

import torch

_DTYPES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def resolve_dtype(name):
    """'float32' / 'bfloat16' / torch dtype / None -> torch dtype or None."""
    if name is None:
        return None
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown precision {name!r}; expected one of {sorted(_DTYPES)}") from None


def compute_dtype_scope(dtype, device, cache_enabled=None):
    """The context a forward runs in: ``torch.autocast`` to bfloat16 on
    ``device``'s type for bfloat16, a null context for float32 or None.
    ``cache_enabled`` goes to ``torch.autocast`` (None: its default, the
    cast cache on); a CUDA graph is captured with it False."""
    dtype = resolve_dtype(dtype)
    if dtype in (None, torch.float32):
        return contextlib.nullcontext()
    if dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute dtype {dtype}; expected float32 or bfloat16")
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                          cache_enabled=cache_enabled)
