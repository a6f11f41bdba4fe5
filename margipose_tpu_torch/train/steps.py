"""Train and eval steps on one device.

Counterpart of ``margipose_tpu/train/steps.py:75-185``: forward in train
mode, masked 2D/3D loss through the fused DSNT+JSD head, backward (the
head's gradient is the CUDA backward kernel on the card), optimiser update
and BN running-stat update. With ``compute_dtype`` bfloat16 the forward and
the loss run under autocast (``parallel/precision.py``) and the backward and
the update outside it: parameters, their gradients, the optimiser state and
the BN statistics stay float32. bf16 has float32's exponent range, so there
is no loss scaling, as in the JAX step. Where the JAX step returns a new state, the
port updates the model, the optimiser and the step counter in place.
Multi-device steps (the JAX package's mesh and shard_map paths) are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from margipose_tpu_torch.bin.eval_3d import make_forward
from margipose_tpu_torch.models.margipose import margipose_masked_loss
from margipose_tpu_torch.parallel.precision import compute_dtype_scope
from margipose_tpu_torch.train.schedules import ScheduledOptimiser


@dataclasses.dataclass
class TrainState:
    """The model, its optimiser and the number of updates made."""

    model: torch.nn.Module
    optimiser: ScheduledOptimiser
    step: int = 0


def make_train_step(pixelwise_loss='jsd', compute_dtype=None):
    """``train_step(state, batch) -> {loss, pred}``, updating ``state`` in place.

    ``batch`` holds device tensors: input [B, 3, H, W] f32, target [B, J, >=3]
    f32, joint_mask [B, J] f32, valid_depth [B] int. ``loss`` (scalar) and
    ``pred`` ([B, J, 3]) stay on the device: nothing is read back."""

    def train_step(state: TrainState, batch):
        model = state.model.train()
        with compute_dtype_scope(compute_dtype, batch['input'].device):
            xyz, out = model(batch['input'])
            loss = margipose_masked_loss(out, batch['target'][..., :3], batch['joint_mask'],
                                         batch['valid_depth'], pixelwise_loss)
        state.optimiser.zero_grad()
        loss.backward()
        state.optimiser.step()
        state.step += 1
        return {'loss': loss.detach(), 'pred': xyz.detach()}

    return train_step


def make_eval_step(pixelwise_loss='jsd', compute_dtype=None):
    """``eval_step(model, batch) -> {loss, pred}`` in eval mode, no gradients."""

    def eval_step(model, batch):
        forward = make_forward(model.eval(), pixelwise_loss, compute_dtype)
        pred, loss = forward(batch['input'], batch['target'][..., :3], batch['joint_mask'],
                             batch['valid_depth'])
        return {'loss': loss, 'pred': pred}

    return eval_step
