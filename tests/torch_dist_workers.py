"""Worker processes for the port's multi-process tests (not a test module).

``spawn_gloo`` runs a function in ``world`` processes joined by a gloo
process group through a file store (no port to collide over between test
workers), each with one intra-op thread. Run as a script under torchrun,
this module trains through ``margipose_tpu_torch.bin.train_3d.main`` and
writes each process's final model state to ``<out>/rank<r>.pt``::

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_dist_workers.py OUT -- --device cpu with ...
"""

import hashlib
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}', rank=rank,
                           world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_gloo(fn, world, tmp_dir, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes under a gloo
    group; raises what a process raised."""
    os.environ['OMP_NUM_THREADS'] = '1'
    mp.spawn(_entry, args=(fn, world, os.path.join(str(tmp_dir), 'store'), args),
             nprocs=world, join=True)


def batch_norm_worker(rank, world, x, upstream, state, out_dir):
    """One train-mode pass of the port's BatchNorm2d over this process's rows
    of ``x``, backward from ``upstream``'s rows; saves the output, the input
    gradient, the parameter gradients and the buffers."""
    from margipose_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(x.shape[1])
    bn.load_state_dict(state)
    rows = slice(rank * x.shape[0] // world, (rank + 1) * x.shape[0] // world)
    xr = x[rows].clone().requires_grad_()
    out = bn.train()(xr)
    (out * upstream[rows]).sum().backward()
    torch.save({'out': out.detach(), 'grad_x': xr.grad,
                'grad_w': bn.weight.grad, 'grad_b': bn.bias.grad,
                'buffers': {k: v.clone() for k, v in bn.state_dict().items()}},
               os.path.join(out_dir, f'bn{rank}.pt'))


def train_step_worker(rank, world, desc, state_dict, batch, schedule, out_dir):
    """One port train step (DistributedDataParallel under the group) on this
    process's rows of the global ``batch``; saves the model state, loss and
    predictions."""
    from margipose_tpu_torch.models import create_model
    from margipose_tpu_torch.parallel.mesh import host_local_slice
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    model = create_model(desc)
    model.load_state_dict(state_dict, strict=True)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, **schedule))
    rows = host_local_slice(batch['input'].shape[0])
    metrics = make_train_step('jsd')(state, {k: v[rows] for k, v in batch.items()})
    torch.save({'model': model.state_dict(), 'loss': metrics['loss'], 'pred': metrics['pred'],
                'ddp': state.replica is not None},
               os.path.join(out_dir, f'step{rank}.pt'))


def in_turn(rank, world, jobs):
    """Each ``(worker, args)`` of ``jobs`` in turn, in one process group."""
    for fn, args in jobs:
        fn(rank, world, *args)


def tensor_parallel_worker(rank, world, shape, desc, state_dict, batch, schedule, out_dir,
                           fault=None):
    """An eval step, a train step and a checkpoint save and restore on a
    ``shape`` mesh (``mesh.make_mesh``; None: the default) with the model
    placed by ``mesh.shard_variables``, on this process's data coordinate's
    rows of the global ``batch``. Saves to ``<out_dir>/<d>x<m>[-fault]-<rank>.pt``
    the loss, the predictions, the input's gradient, the eval step's results,
    whether the checkpoint's restore gave back this process's weights and
    momentum (not checked with a fault), the mesh's layout, a digest of the gathered state and, from
    process 0, the gathered state itself. ``fault='model_all_reduce'`` drops
    the 'model' all-reduce of the column-parallel layers' input gradient (a
    planted fault) for this call."""
    from margipose_tpu_torch.models import create_model
    from margipose_tpu_torch.parallel import mesh
    from margipose_tpu_torch.train import checkpoint
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_eval_step, make_train_step

    grid = mesh.make_mesh(shape)
    name = f'{grid.shape["data"]}x{grid.shape["model"]}' + (f'-{fault}' if fault else '')
    model = create_model(desc)
    model.load_state_dict(state_dict, strict=True)
    mesh.shard_variables(model, grid)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, **schedule))
    local = mesh.shard_batch(batch, grid)
    evaluated = make_eval_step('jsd', mesh=grid)(model, local)
    local['input'] = local['input'].clone().requires_grad_()
    real_backward = mesh._CopyToModel.backward
    if fault == 'model_all_reduce':
        mesh._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        metrics = make_train_step('jsd', mesh=grid)(state, local)
    finally:
        mesh._CopyToModel.backward = real_backward
    round_trip = None
    if fault is None:
        ckpt_dir = os.path.join(out_dir, f'ckpt-{name}')
        checkpoint.save_checkpoint(ckpt_dir, state, desc)
        plain = create_model(desc)
        restored = TrainState(mesh.shard_variables(plain, grid), make_optimiser(
            '1cycle', plain.parameters(), 1.0, **schedule))
        checkpoint.restore_checkpoint(ckpt_dir, restored)
        live, back = (s.optimiser.state_dict() for s in (state, restored))
        weights = restored.model.state_dict()
        round_trip = (all(torch.equal(v, weights[k]) for k, v in model.state_dict().items())
                      and restored.step == state.step and live['count'] == back['count']
                      and all(torch.equal(a['momentum_buffer'], b['momentum_buffer'])
                              for a, b in zip(live['optimiser']['state'].values(),
                                              back['optimiser']['state'].values())))
    full = mesh.full_state_dict(model)
    digest = hashlib.sha256()
    for key, value in full.items():
        digest.update(key.encode() + value.numpy().tobytes())
    torch.save({'model': full if rank == 0 else None, 'digest': digest.hexdigest(),
                'loss': metrics['loss'], 'pred': metrics['pred'],
                'grad_input': local['input'].grad, 'eval_loss': evaluated['loss'],
                'eval_pred': evaluated['pred'], 'ddp': state.replica is not None,
                'shape': grid.shape, 'coords': grid.coords,
                'shardings': mesh.param_shardings(grid, model), 'round_trip': round_trip,
                'local_shapes': {k: tuple(v.shape) for k, v in model.state_dict().items()}},
               os.path.join(out_dir, f'{name}-{rank}.pt'))


def _train_bin(out_dir, argv):
    import margipose_tpu_torch.bin.train_3d as train_3d

    seen = {}
    real_pass = train_3d.do_training_pass

    def remember_state(cfg, state, *args, **kwargs):
        seen['state'] = state
        return real_pass(cfg, state, *args, **kwargs)

    train_3d.do_training_pass = remember_state
    result = train_3d.main(argv)
    rank = int(os.environ['RANK'])
    torch.save({'model': seen['state'].model.state_dict(), 'result': result},
               os.path.join(out_dir, f'rank{rank}.pt'))


if __name__ == '__main__':
    torch.set_num_threads(1)
    split = sys.argv.index('--')
    _train_bin(sys.argv[1], sys.argv[split + 1:])
