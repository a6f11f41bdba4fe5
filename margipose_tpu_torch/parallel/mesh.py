"""The process group of a multi-GPU run, and its small helpers.

Counterpart of ``margipose_tpu/parallel/mesh.py``. The JAX package forms a
pure-data ``(n, 1)`` mesh over every chip and, on a multi-host slice, joins
the hosts from ``TPU_WORKER_HOSTNAMES``. The port runs one process per GPU
under ``torchrun`` (``python -m torch.distributed.run``) and forms its
process group from torchrun's environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on the card, each
process on ``cuda:LOCAL_RANK``; gloo on the CPU, for the tests.

While a group is active the train and eval steps reduce over the global
batch: batch-norm statistics (``models/layers.BatchNorm2d``) and the masked
loss's numerator and denominator (``ops/dsnt.average_loss``), as the JAX
package's shard_map steps psum them.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


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


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over every process, differentiably: the backward
    sums the processes' gradients, the transpose of a sum whose result every
    process holds (``torch.distributed.nn.functional.all_reduce``, which
    newer torch deprecates)."""
    return _AllReduceSum.apply(tensor)


def host_local_slice(global_batch_size: int, process_index=None,
                     process_count=None) -> slice:
    """Rows of the global batch this process is responsible for loading.

    Each process runs its own input pipeline and loads ``global_batch_size /
    process_count`` examples; processes own contiguous row blocks in
    process-index order, the layout of the JAX package's
    ``jax.make_array_from_process_local_data`` for a batch-sharded array.
    """
    pc = _process_count() if process_count is None else process_count
    pi = _process_index() if process_index is None else process_index
    assert global_batch_size % pc == 0, (
        f"global batch {global_batch_size} must divide over {pc} processes")
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)
