"""margipose_tpu_torch: the PyTorch/CUDA port of margipose_tpu.

The layout mirrors the JAX package so each module's counterpart is easy to
find:
  ops/       DSNT numerics, the hand-written CUDA DSNT+JSD kernels, forward
             and backward (csrc/), and batched image ops (image.py)
  geometry/  camera model, skeleton math, normalisation, 2D transforms (numpy)
  models/    NCHW nn.Modules with the reference state_dict keys + registry
  data/      host datasets, the thread-pool loader (numpy), uint8 upload
  parallel/  the bf16 autocast policy (precision.py), the multi-GPU process
             group (mesh.py)
  train/     train/eval steps, schedules, train-state checkpoints, meters
  bin/       CLI entry points (eval_3d, train_3d, infer_single, serve)

The port imports nothing of ``margipose_tpu``; the numpy host code is a copy.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA where no card
    is present is an error, never a silent switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return device
