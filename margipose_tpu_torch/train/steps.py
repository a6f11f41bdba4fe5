"""Train and eval steps, on one device or under a process group.

Counterpart of ``margipose_tpu/train/steps.py:75-208``: forward in train
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
the masked loss's numerator and denominator are all-reduced over the
mesh's 'data' axis, and the train step's forward and backward go through
DistributedDataParallel over that axis's group, which averages the
gradients. The loss's differentiable all-reduce multiplies each process's
gradient by the data axis's size d, so the average is the gradient of the
global masked mean even when the processes hold different numbers of
unmasked joints (MPII's 2D rows in the mixed recipe); the gradient of the
input, which DDP does not average, stays d times the global one. Without
a ``mesh`` the data axis is every process (pure data parallelism).

On a hybrid ``(d, m)`` mesh (``mesh.make_mesh``, the model placed by
``mesh.shard_variables``) the steps give what the JAX package's GSPMD step
gives (``margipose_tpu/train/steps.py:52-72``): the m processes of a data
coordinate hold the same rows and each computes its slice of every
sharded convolution (``mesh.ColumnParallelConv``), so the sharded weights'
gradients are complete slices and the replicated ones whole on every
model peer (averaged over 'model' all the same, so that rounding on the
card does not set the replicas apart). DDP runs over the 'data' group only
where d > 1.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
from torch.nn.parallel import DistributedDataParallel

from margipose_tpu_torch import tracing
from margipose_tpu_torch.bin.eval_3d import make_forward
from margipose_tpu_torch.models.margipose import margipose_masked_loss
from margipose_tpu_torch.parallel.mesh import (
    ColumnParallelConv,
    average_replicated_gradients,
    group_active,
)
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


def make_train_step(pixelwise_loss='jsd', compute_dtype=None, mesh=None):
    """``train_step(state, batch) -> {loss, pred}``, updating ``state`` in place.

    ``batch`` holds device tensors: input [B, 3, H, W] f32, target [B, J, >=3]
    f32, joint_mask [B, J] f32, valid_depth [B] int: this process's rows
    (``parallel.mesh.shard_batch``). ``loss`` (scalar) and ``pred`` ([B, J,
    3]) stay on the device: nothing is read back. ``mesh``: the
    ``parallel.mesh.Mesh`` the model was placed on (None: every process on
    the data axis). While ``tracing`` is on, the step and its forward, loss,
    backward and update are recorded as spans."""
    group = None if mesh is None else mesh.data_group

    def train_step(state: TrainState, batch):
        with tracing.span('train.step', state.step):
            distributed = group_active()
            model = state.model.train()
            if distributed and (mesh is None or mesh.shape['data'] > 1):
                if state.replica is None:
                    # BN buffers are computed from all-reduced statistics, so
                    # they agree on every process without a broadcast (newer
                    # torch renames the option and warns)
                    with warnings.catch_warnings():
                        warnings.simplefilter('ignore', FutureWarning)
                        state.replica = DistributedDataParallel(model, process_group=group,
                                                                broadcast_buffers=False)
                model = state.replica
            with compute_dtype_scope(compute_dtype, batch['input'].device):
                with tracing.span('train.forward'):
                    xyz, out = model(batch['input'])
                with tracing.span('train.loss'):
                    loss = margipose_masked_loss(out, batch['target'][..., :3],
                                                 batch['joint_mask'], batch['valid_depth'],
                                                 pixelwise_loss, distributed, group)
            state.optimiser.zero_grad()
            with tracing.span('train.backward'):
                loss.backward()
                if mesh is not None:
                    average_replicated_gradients(state.model, mesh)
            with tracing.span('train.update'):
                state.optimiser.step()
            state.step += 1
        return {'loss': loss.detach(), 'pred': xyz.detach()}

    return train_step


def make_eval_step(pixelwise_loss='jsd', compute_dtype=None, mesh=None):
    """``eval_step(model, batch) -> {loss, pred}`` in eval mode, no gradients;
    under a process group the loss is the global batch's (over ``mesh``'s
    'data' axis, as in ``make_train_step``)."""
    group = None if mesh is None else mesh.data_group

    def eval_step(model, batch):
        forward = make_forward(model.eval(), pixelwise_loss, compute_dtype,
                               group_active(), group)
        pred, loss = forward(batch['input'], batch['target'][..., :3], batch['joint_mask'],
                             batch['valid_depth'])
        return {'loss': loss, 'pred': pred}

    return eval_step


def make_forward_fn(model, compute_dtype=None, mesh=None):
    """``forward(images) -> xyz``: inference alone, ``images`` [B, 3, H, W]
    float32 on the model's device to float32 coordinates [B, J, 3], in eval
    mode under ``torch.inference_mode()`` and ``compute_dtype_scope``. No
    loss, so no loss-head kernel.

    Counterpart of ``margipose_tpu/train/steps.py:188-208``. ``mesh`` as in
    ``make_train_step``; the forward needs no collective on either kind.
    Where JAX runs a pure data-parallel mesh under ``shard_map`` (images
    split over 'data', weights replicated), each process passes its own
    rows (``parallel.mesh.shard_batch``). On a hybrid mesh ('model' > 1)
    ``model`` must be the one ``parallel.mesh.shard_variables`` cut: its
    ``ColumnParallelConv``s gather over 'model', and JAX's GSPMD path does
    the same. The model is put in eval mode here, and again by a call that
    finds it in train mode (a per-call ``eval()`` walks every module, which
    costs milliseconds on the flagship)."""
    if (mesh is not None and mesh.shape['model'] > 1
            and not any(isinstance(m, ColumnParallelConv) for m in model.modules())):
        raise ValueError(f"a mesh with 'model' = {mesh.shape['model']} needs the model "
                         'parallel.mesh.shard_variables placed on it')
    model.eval()

    def forward(images):
        if model.training:
            model.eval()
        with torch.inference_mode(), compute_dtype_scope(compute_dtype, images.device):
            xyz, _ = model(images)
        return xyz.float()

    return forward
