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
import inspect
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
    step under a process group; ``graph`` the step captured in a CUDA graph
    and ``warmed`` the graph key of the step before, if it ran eagerly
    (``make_train_step``)."""

    model: torch.nn.Module
    optimiser: ScheduledOptimiser
    step: int = 0
    replica: DistributedDataParallel | None = None
    graph: StepGraph | None = None
    warmed: tuple | None = None


@dataclasses.dataclass
class StepGraph:
    """A train step captured in a CUDA graph. ``key`` is what it was captured
    for (``graph_key``), ``inputs`` the static batch it reads, ``loss`` and
    ``pred`` its static outputs (the next replay overwrites them)."""

    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: dict
    loss: torch.Tensor
    pred: torch.Tensor


GRAPH_DEVICES = ('cuda',)


def graph_key(train_step, state: TrainState, batch, mesh=None):
    """What a graph of ``train_step`` stepping ``state`` on ``batch`` is
    captured for: the step function, the optimiser's ``graph_key`` and the
    batch's keys, shapes, dtypes and device. None where the step runs
    eagerly: a batch off the card, an active process group, a ``mesh``, or
    an optimiser that cannot take its schedule from the device."""
    if mesh is not None or group_active():
        return None
    if any(v.device.type not in GRAPH_DEVICES for v in batch.values()):
        return None
    optimiser = state.optimiser.graph_key()
    if optimiser is None:
        return None
    return train_step, optimiser, tuple((k, v.shape, v.dtype, v.device) for k, v in batch.items())


def step_counts(train_step):
    """How ``train_step`` (``make_train_step``'s, or a ``functools.wraps``
    wrapper of it) ran its steps so far: ``eager_steps``, ``captures`` and
    ``replays``."""
    train_step = inspect.unwrap(train_step)
    return {k: getattr(train_step, k) for k in ('eager_steps', 'captures', 'replays')}


def eager(train_step, state: TrainState, batch):
    """One step of ``train_step`` run eagerly whatever ``state`` held: its
    graph and warm key are dropped first, so the step neither replays nor
    captures. What a graphed step is held against."""
    state.graph = state.warmed = None
    return train_step(state, batch)


def make_train_step(pixelwise_loss='jsd', compute_dtype=None, mesh=None):
    """``train_step(state, batch) -> {loss, pred}``, updating ``state`` in place.

    ``batch`` holds device tensors: input [B, 3, H, W] f32, target [B, J, >=3]
    f32, joint_mask [B, J] f32, valid_depth [B] int: this process's rows
    (``parallel.mesh.shard_batch``). ``loss`` (scalar) and ``pred`` ([B, J,
    3]) stay on the device: nothing is read back; each call returns fresh
    tensors. ``mesh``: the ``parallel.mesh.Mesh`` the model was placed on
    (None: every process on the data axis).

    On one card the whole step (forward, loss with both loss-head kernels,
    backward, the SGD update) is captured in a CUDA graph and replayed, so
    the host launches it once, not some 9,000 kernels. A step whose
    ``graph_key`` is None runs eagerly (the CPU, a process group, a mesh,
    RMSprop). Otherwise: the step matching the state's graph replays it,
    after device-to-device copies of the batch into the graph's inputs; the
    first step of a new key runs eagerly on the capture stream (cuDNN's
    timed search, the momentum buffers, the stream's lazy handles), and the
    step after it, with the same key, captures the graph and replays it. A
    differing step in between (a short last batch) runs eagerly and leaves
    the graph; ``load_state_dict`` on the optimiser drops it. The eager
    step is the graph's body. ``train_step.eager_steps``, ``.captures`` and
    ``.replays`` count the steps each way (a capture step replays once too,
    and counts as a capture). The loss-head kernels' ``launches`` count
    their host launches: one on an eager or capturing step, none on a
    replay, which runs the captured kernels on the card.

    While ``tracing`` is on, the step is a ``train.step`` span; eager and
    capturing steps record their forward, loss, backward and update, a
    capture is ``train.capture`` and a replay ``train.replay``."""
    group = None if mesh is None else mesh.data_group
    streams = {}  # device -> the stream graphs are captured on

    def run(state, batch, update, capturing=False):
        """Forward, loss, backward and ``update()``: the eager step and the
        graph's body (``capturing``: autocast without its cast cache, which
        capture needs)."""
        distributed = group_active()
        model = state.model
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
        with compute_dtype_scope(compute_dtype, batch['input'].device,
                                 cache_enabled=False if capturing else None):
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
            update()
        return loss.detach(), xyz.detach()

    def warm(state, batch):
        """The eager step on the capture stream."""
        device = batch['input'].device
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        stream = streams[device]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = run(state, batch, state.optimiser.step)
        torch.cuda.current_stream(device).wait_stream(stream)
        return out

    def capture(state, batch, key):
        state.graph = None  # its memory pool goes before the next is made
        inputs = {k: v.clone() for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=streams[batch['input'].device]):
            loss, xyz = run(state, inputs, state.optimiser.update, capturing=True)
        state.graph = StepGraph(key, graph, inputs, loss, xyz)

    def replay(state, batch):
        g = state.graph
        state.optimiser.set_schedule()
        for k, v in batch.items():
            g.inputs[k].copy_(v)
        g.graph.replay()
        state.optimiser.count += 1
        return g.loss.clone(), g.pred.clone()

    def train_step(state: TrainState, batch):
        with tracing.span('train.step', state.step):
            state.model.train()
            key = graph_key(train_step, state, batch, mesh)
            warmed, state.warmed = state.warmed, None
            if state.graph is not None and state.graph.key[1] != state.optimiser.graph_key():
                state.graph = None  # its buffers were replaced (load_state_dict): free it now
            if key is None:
                loss, xyz = run(state, batch, state.optimiser.step)
                train_step.eager_steps += 1
            elif state.graph is not None and state.graph.key == key:
                with tracing.span('train.replay'):
                    loss, xyz = replay(state, batch)
                train_step.replays += 1
            elif warmed == key:
                with tracing.span('train.capture'):
                    capture(state, batch, key)
                with tracing.span('train.replay'):
                    loss, xyz = replay(state, batch)
                train_step.captures += 1
            else:
                loss, xyz = warm(state, batch)
                state.warmed = key
                train_step.eager_steps += 1
            state.step += 1
        return {'loss': loss, 'pred': xyz}

    train_step.eager_steps = train_step.captures = train_step.replays = 0
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
