"""Train and eval steps, on one device or under a process group.

Counterpart of ``margipose_tpu/train/steps.py:75-185``: forward in train
mode, masked 2D/3D loss through the fused DSNT+JSD head, backward (the
head's gradient is the CUDA backward kernel on the card), optimiser update
and BN running-stat update. With ``compute_dtype`` bfloat16 the forward and
the loss run under autocast (``parallel/precision.py``) and the backward and
the update outside it: parameters, their gradients, the optimiser state and
the BN statistics stay float32. bf16 has float32's exponent range, so there
is no loss scaling, as in the JAX step. Where the JAX step returns a new state, the
port updates the model, the optimiser and the step counter in place.

While a process group is active (``parallel/mesh.py``) the steps run as the
JAX package's shard_map steps do (``margipose_tpu/train/steps.py:48-70``):
each process holds its rows of the global batch, batch-norm statistics and
the masked loss's numerator and denominator are all-reduced, and the train
step's forward and backward go through DistributedDataParallel, which
averages the gradients. The loss's differentiable all-reduce multiplies
each process's gradient by the number of processes, so the average is the
gradient of the global masked mean even when the processes hold different
numbers of unmasked joints (MPII's 2D rows in the mixed recipe).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
from torch.nn.parallel import DistributedDataParallel

from margipose_tpu_torch.bin.eval_3d import make_forward
from margipose_tpu_torch.models.margipose import margipose_masked_loss
from margipose_tpu_torch.parallel import mesh
from margipose_tpu_torch.parallel.precision import compute_dtype_scope
from margipose_tpu_torch.train.schedules import ScheduledOptimiser


@dataclasses.dataclass
class TrainState:
    """The model, its optimiser and the number of updates made; ``replica``
    is the model's DistributedDataParallel wrapper, made by the first train
    step under a process group."""

    model: torch.nn.Module
    optimiser: ScheduledOptimiser
    step: int = 0
    replica: DistributedDataParallel | None = None


def make_train_step(pixelwise_loss='jsd', compute_dtype=None):
    """``train_step(state, batch) -> {loss, pred}``, updating ``state`` in place.

    ``batch`` holds device tensors: input [B, 3, H, W] f32, target [B, J, >=3]
    f32, joint_mask [B, J] f32, valid_depth [B] int. ``loss`` (scalar) and
    ``pred`` ([B, J, 3]) stay on the device: nothing is read back."""

    def train_step(state: TrainState, batch):
        distributed = mesh.group_active()
        model = state.model.train()
        if distributed:
            if state.replica is None:
                # BN buffers are computed from all-reduced statistics, so
                # they agree on every process without a broadcast (newer
                # torch renames the option and warns)
                with warnings.catch_warnings():
                    warnings.simplefilter('ignore', FutureWarning)
                    state.replica = DistributedDataParallel(model, broadcast_buffers=False)
            model = state.replica
        with compute_dtype_scope(compute_dtype, batch['input'].device):
            xyz, out = model(batch['input'])
            loss = margipose_masked_loss(out, batch['target'][..., :3], batch['joint_mask'],
                                         batch['valid_depth'], pixelwise_loss, distributed)
        state.optimiser.zero_grad()
        loss.backward()
        state.optimiser.step()
        state.step += 1
        return {'loss': loss.detach(), 'pred': xyz.detach()}

    return train_step


def make_eval_step(pixelwise_loss='jsd', compute_dtype=None):
    """``eval_step(model, batch) -> {loss, pred}`` in eval mode, no gradients;
    under a process group the loss is the global batch's."""

    def eval_step(model, batch):
        forward = make_forward(model.eval(), pixelwise_loss, compute_dtype,
                               mesh.group_active())
        pred, loss = forward(batch['input'], batch['target'][..., :3], batch['joint_mask'],
                             batch['valid_depth'])
        return {'loss': loss, 'pred': pred}

    return eval_step
