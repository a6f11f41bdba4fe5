"""The process group of a multi-GPU run, its ('data', 'model') mesh, and the
tensor-parallel sharding of the model's convolutions.

Counterpart of ``margipose_tpu/parallel/mesh.py``. The JAX package lays a
('data', 'model') mesh over its chips and leaves the collectives to GSPMD.
The port runs one process per GPU under ``torchrun`` (``python -m
torch.distributed.run``) and forms its process group from torchrun's
environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on the card, each process on ``cuda:LOCAL_RANK``;
gloo on the CPU, for the tests. ``make_mesh`` lays the processes out as JAX
lays out devices (rank r at ``(r // m, r % m)``) and forms one process group
per row ('model') and per column ('data') of that grid.

While a group is active the train and eval steps reduce over the global
batch along 'data': batch-norm statistics (``models/layers.BatchNorm2d``,
through its ``process_group``) and the masked loss's numerator and
denominator (``ops/dsnt.average_loss``), as the JAX package's steps psum
them. Without a mesh, 'data' spans every process (``make_mesh()``, pure
data parallelism). The processes that share a data coordinate hold the
same rows, so a collective over the whole world would count them once per
model peer: every data-parallel collective takes the 'data' group.

Tensor parallelism (``_param_spec``, ``param_shardings``, ``shard_variables``)
is JAX's rule: a convolution's output channels are split over 'model' where
they divide and number at least 2m; everything else is replicated. torch's
DTensor has no convolution rule for a weight sharded on output channels, so
``ColumnParallelConv`` writes it out as Megatron does its column-parallel
linear layer: identity forward and 'model' all-reduce backward on the input,
the local convolution on this process's slice of output channels, and an
all-gather of the channels forward whose backward takes the local slice.
Everything after a gather is replicated across model peers, so the slice is
the whole gradient.

The JAX module's other names and where their jobs went in the port:
  * ``batch_sharding`` / ``replicated_sharding``: there is no sharding object
    to return; a process holds its data coordinate's rows (``shard_batch``)
    and a replicated tensor is a full copy in every process;
  * ``put_batch_array``: each process's loader reads its own rows
    (``host_local_slice``) and ``data/specs.to_device`` uploads them; no
    global array is assembled;
  * ``host_local_values``: a tensor is already this process's rows.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

def group_active() -> bool:
    """Whether a process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if group_active() else 0


def process_count() -> int:
    return dist.get_world_size() if group_active() else 1


_process_index, _process_count = process_index, process_count


def init_from_env(device: torch.device) -> torch.device:
    """Join the process group torchrun's environment describes, and return
    the device this process runs on: ``cuda:LOCAL_RANK`` (NCCL) on the card,
    ``device`` (gloo) on the CPU. Without torchrun's environment, or with a
    group already formed, nothing is joined and ``device`` comes back."""
    if 'WORLD_SIZE' not in os.environ or 'RANK' not in os.environ or group_active():
        return device
    if device.type == 'cuda':
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(device)
        dist.init_process_group('nccl', device_id=device)
    else:
        dist.init_process_group('gloo')
    print(f'torch.distributed: process {process_index()}/{process_count()} '
          f'({dist.get_backend()}) on {device}', flush=True)
    return device


def shutdown() -> None:
    if group_active():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every process (no-op without a group)."""
    if group_active():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` as process ``src`` holds it (no-op without a group)."""
    if not group_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a ('data', 'model') grid of processes.

    ``shape`` and ``coords`` map each axis name to its size and to this
    process's index along it. ``data_group`` joins the processes that share
    this one's model coordinate, ``model_group`` those that share its data
    coordinate; either is None where it spans every process (the default
    group of ``torch.distributed``)."""

    shape: dict
    coords: dict
    data_group: object = None
    model_group: object = None


def make_mesh(shape=None) -> Mesh:
    """The mesh of ``shape`` (data, model) over every process; the default
    ``(world, 1)`` is pure data parallelism. Collective: every process calls
    it, and each forms every subgroup in the same order."""
    world = process_count()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or int(np.prod(shape)) != world:
        raise ValueError(f'mesh shape {shape} != {world} processes')
    d, m = shape
    rank = process_index()
    groups = {}
    for axis, size, members in (
            ('data', d, [[k + i * m for i in range(d)] for k in range(m)]),
            ('model', m, [[i * m + k for k in range(m)] for i in range(d)])):
        if size < world:
            groups[axis], _ = dist.new_subgroups_by_enumeration(members)
    return Mesh(shape={'data': d, 'model': m}, coords={'data': rank // m, 'model': rank % m},
                data_group=groups.get('data'), model_group=groups.get('model'))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over the processes of ``group`` (None: every
    process), differentiably: the backward sums the processes' gradients,
    the transpose of a sum whose result every process holds
    (``torch.distributed.nn.functional.all_reduce``, which newer torch
    deprecates)."""
    return _AllReduceSum.apply(tensor, group)


def _gather(tensor, dim, group, size):
    parts = torch.empty((size,) + tuple(tensor.shape), dtype=tensor.dtype, device=tensor.device)
    dist.all_gather(list(parts.unbind(0)), tensor.contiguous(), group=group)
    return torch.cat(parts.unbind(0), dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, dim, group, size, index):
        ctx.dim, ctx.index, ctx.width = dim, index, tensor.shape[dim]
        return _gather(tensor, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        local = grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous()
        return local, None, None, None, None


def all_gather(tensor: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model peers' ``tensor``s concatenated on ``dim`` in coordinate
    order. Its backward takes this process's slice of the gradient: right
    where what follows is replicated over 'model', so that every process's
    gradient is the whole one (a column-parallel layer's output)."""
    return _AllGather.apply(tensor, dim, mesh.model_group, mesh.shape['model'],
                            mesh.coords['model'])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ColumnParallelConv(nn.Module):
    """A convolution (or transposed convolution) holding this process's
    contiguous slice of its output channels, ``[k o/m, (k+1) o/m)`` at model
    coordinate k; its output is the full layer's, on every model peer. The
    weight keeps the layer's name and layout (``[out, in, kh, kw]``, and
    ``[in, out, kh, kw]`` transposed), so a state_dict differs from the
    plain model's only in the sharded dimension's size. A bias is
    replicated and added after the gather."""

    def __init__(self, conv: nn.Conv2d | nn.ConvTranspose2d, mesh: Mesh):
        super().__init__()
        self.transposed = isinstance(conv, nn.ConvTranspose2d)
        self.dim = _param_spec(conv, mesh.shape['model'])
        if self.dim is None:
            raise ValueError(f'{conv} is not sharded over {mesh.shape["model"]} processes')
        self.mesh = mesh
        self.width = conv.weight.shape[self.dim] // mesh.shape['model']
        self.weight = nn.Parameter(self.local(conv.weight.detach()).clone(),
                                   requires_grad=conv.weight.requires_grad)
        self.bias = conv.bias
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.output_padding = conv.output_padding if self.transposed else None

    def forward(self, x):
        x = _CopyToModel.apply(x, self.mesh.model_group)
        if self.transposed:
            y = F.conv_transpose2d(x, self.weight, None, self.stride, self.padding,
                                   self.output_padding, 1, self.dilation)
        else:
            y = F.conv2d(x, self.weight, None, self.stride, self.padding, self.dilation)
        y = all_gather(y, 1, self.mesh)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1).to(y.dtype)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This process's slice of a tensor of the full weight's shape."""
        return full.narrow(self.dim, self.mesh.coords['model'] * self.width, self.width)

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """A tensor of the local weight's shape gathered over 'model' into
        the full weight's shape (collective, not differentiable)."""
        return _gather(local, self.dim, self.mesh.model_group, self.mesh.shape['model'])

    def extra_repr(self):
        return (f'{"transposed, " if self.transposed else ""}weight dim {self.dim} sharded '
                f'{self.mesh.shape["model"]} ways, local {tuple(self.weight.shape)}')


def _param_spec(module: nn.Module, model_axis_size: int) -> int | None:
    """Tensor-parallel rule, JAX's stated on the port's modules: the weight
    dimension of a convolution's output channels, sharded over 'model' where
    the channels divide over it and number at least twice its size; None
    (replicated) for everything else. The dimension comes from the module's
    type, never the tensor's rank: 0 for ``nn.Conv2d`` (``[out, in, kh,
    kw]``), 1 for ``nn.ConvTranspose2d`` (``[in, out, kh, kw]``; JAX stores
    its transposed kernels with the output features last, as a forward
    convolution's). Grouped convolutions, which no model of the port has,
    stay replicated."""
    if isinstance(module, ColumnParallelConv):
        return module.dim
    if model_axis_size <= 1 or not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        return None
    if module.groups != 1 or module.padding_mode != 'zeros':
        return None
    dim = 1 if isinstance(module, nn.ConvTranspose2d) else 0
    out_ch = module.weight.shape[dim]
    if out_ch % model_axis_size == 0 and out_ch >= 2 * model_axis_size:
        return dim
    return None


def param_shardings(mesh: Mesh, model: nn.Module) -> dict:
    """``{state_dict key: the dimension sharded over 'model', or None}`` for
    ``model`` (plain or already sharded) on ``mesh``."""
    specs = dict.fromkeys(model.state_dict())
    for name, module in model.named_modules():
        dim = _param_spec(module, mesh.shape['model'])
        if dim is not None:
            specs[f'{name}.weight'] = dim
    return specs


def _sharded_modules(model: nn.Module) -> dict:
    return {name: m for name, m in model.named_modules() if isinstance(m, ColumnParallelConv)}


def shard_variables(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place ``model`` on ``mesh``, in place: every convolution the rule
    shards becomes a ``ColumnParallelConv`` holding this process's slice of
    the weights, and every batch norm takes its statistics over the 'data'
    group. The weights must be equal in every process beforehand (a common
    seed, or a broadcast): each process keeps its slice of its own copy.
    Build the optimiser afterwards, over the sharded parameters. Returns
    ``model``."""
    from margipose_tpu_torch.models.layers import BatchNorm2d

    m = mesh.shape['model']
    for name, module in list(model.named_modules()):
        if isinstance(module, BatchNorm2d):
            module.process_group = mesh.data_group
        elif _param_spec(module, m) is not None and not isinstance(module, ColumnParallelConv):
            parent, _, child = name.rpartition('.')
            setattr(model.get_submodule(parent), child, ColumnParallelConv(module, mesh))
    return model


def average_replicated_gradients(model: nn.Module, mesh: Mesh) -> None:
    """Average the gradients of the parameters replicated over 'model' (all
    but the sharded weights) across the model peers, in one all-reduce.
    Each peer's gradient is already the whole one; on the card, kernels
    that accumulate with atomics (cuDNN's weight-gradient algorithms) round
    them differently in each process, and the replicas would drift apart.
    A no-op where 'model' has one process."""
    m = mesh.shape['model']
    if m == 1:
        return
    sharded = {id(module.weight) for module in _sharded_modules(model).values()}
    grads = [p.grad for p in model.parameters() if p.grad is not None and id(p) not in sharded]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.model_group)
    flat.div_(m)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def full_state_dict(model: nn.Module) -> dict:
    """``model``'s state_dict in the plain model's layout: each sharded
    weight gathered over 'model'. Collective where the model is sharded;
    ``model.state_dict()`` itself otherwise."""
    state = model.state_dict()
    for name, module in _sharded_modules(model).items():
        state[f'{name}.weight'] = module.full(state[f'{name}.weight'])
    return state


def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Load a state_dict in the plain model's layout into ``model``, plain or
    sharded (each process takes its slice of every sharded weight);
    strict."""
    state = dict(state)
    for name, module in _sharded_modules(model).items():
        state[f'{name}.weight'] = module.local(state[f'{name}.weight'])
    model.load_state_dict(state, strict=True)


def _optimiser_layout(optimiser: torch.optim.Optimizer, model: nn.Module) -> dict:
    """``{index in the optimiser's state_dict: its sharded module}``."""
    by_param = {id(m.weight): m for m in _sharded_modules(model).values()}
    params = [p for group in optimiser.param_groups for p in group['params']]
    return {i: by_param[id(p)] for i, p in enumerate(params) if id(p) in by_param}


def _map_optimiser_state(state: dict, layout: dict, fn) -> dict:
    state = {**state, 'state': dict(state['state'])}
    for i, module in layout.items():
        if i in state['state']:
            state['state'][i] = {k: fn(module, v) if isinstance(v, torch.Tensor) and v.dim() > 0
                                 else v for k, v in state['state'][i].items()}
    return state


def full_optimiser_state(optimiser: torch.optim.Optimizer, model: nn.Module) -> dict:
    """``optimiser.state_dict()`` with each sharded parameter's buffers
    (momentum, RMSprop's averages) gathered into the plain model's layout.
    Collective where the model is sharded."""
    return _map_optimiser_state(optimiser.state_dict(), _optimiser_layout(optimiser, model),
                                ColumnParallelConv.full)


def local_optimiser_state(state: dict, optimiser: torch.optim.Optimizer,
                          model: nn.Module) -> dict:
    """A state_dict of ``full_optimiser_state``'s layout cut to this
    process's slices, for ``optimiser.load_state_dict``."""
    return _map_optimiser_state(state, _optimiser_layout(optimiser, model),
                                ColumnParallelConv.local)


def host_local_slice(global_batch_size: int, process_index=None, process_count=None,
                     mesh: Mesh | None = None) -> slice:
    """Rows of the global batch this process is responsible for loading.

    Each process runs its own input pipeline and loads ``global_batch_size /
    process_count`` examples; processes own contiguous row blocks in
    process-index order, the layout of the JAX package's
    ``jax.make_array_from_process_local_data`` for a batch-sharded array.
    With ``mesh`` the rows belong to the data coordinate: ``global / d``
    rows each, the same for every model peer.
    """
    if mesh is not None:
        process_index, process_count = mesh.coords['data'], mesh.shape['data']
    pc = _process_count() if process_count is None else process_count
    pi = _process_index() if process_index is None else process_index
    assert global_batch_size % pc == 0, (
        f"global batch {global_batch_size} must divide over {pc} processes")
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This process's rows (its data coordinate's) of every array of a
    global ``batch``."""
    rows = host_local_slice(len(next(iter(batch.values()))), mesh=mesh)
    return {k: v[rows] for k, v in batch.items()}


def host_local_values(tensor: torch.Tensor) -> np.ndarray:
    """This process's rows of a batch tensor on the host, in global row
    order: the tensor itself, since a process holds only its rows (model
    peers hold the same ones once each)."""
    return tensor.detach().cpu().numpy()
