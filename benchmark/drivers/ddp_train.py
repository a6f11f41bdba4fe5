"""Data-parallel training steps over the cell's cards, one process a card:
what training on several cards with the train bin's global batch costs.

``run`` (in the process that prints the result) starts one worker a card
(``python -m benchmark.drivers.ddp_train``) with torchrun's environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` localhost and a
free ``MASTER_PORT``), and waits for them all. Each worker joins the group
through ``parallel/mesh.init_from_env`` (NCCL, ``cuda:RANK``) and drives the
train cell's program (``drivers/train.program``): the same seeded weights, 1cycle
state and bf16 step (``train/steps.make_train_step``, which wraps the model in
DistributedDataParallel and all-reduces the batch norms' statistics and the
loss over the group), each process on its contiguous block of every global
batch of the seeded pool. The window runs until rank 0's host clock passes
``--seconds``; rank 0 tells the others after each step over a gloo group on
the host, so that every rank runs the same steps. ``ddp_train_images_per_s``
is every image of the global batches over the window's whole time, which
ends when every rank's card is done.

Rank 0 gathers each rank's first-step coordinates and the largest peak of
device memory, profiles the traced steps (``--trace 1``) on its card, and
after the window, with the program freed, steps the plain reference over
the whole global batches (``reference/sgd.global_batch_step``) and judges
the group's losses, coordinates, first gradient and change as the train
cell does.
"""

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import torch

from benchmark import common, compare, costs, faults, trace, traffic, weights
from benchmark.drivers import train


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run(ctx):
    """Start a worker a card and return rank 0's observations."""
    world = ctx.workload['chips']
    out = os.path.join(common.ROOT, 'build', 'benchmark_ddp', f'{os.getpid()}.json')
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # torchrun's environment, its OMP_NUM_THREADS of 1 for several processes a node
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR='localhost',
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS='1')
    args = ['--workload', ctx.workload['name'], '--seed', str(ctx.seed),
            '--seconds', str(ctx.seconds), '--trace', str(int(ctx.trace)),
            '--device', ctx.device.type, '--out', out]
    if getattr(ctx, 'overrides', None):
        args += ['--overrides', json.dumps(ctx.overrides)]
    if getattr(ctx, 'fault', None):
        args += ['--fault', ctx.fault]
    procs = [subprocess.Popen([sys.executable, '-m', 'benchmark.drivers.ddp_train', *args],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=common.ROOT,
                              stdout=sys.stderr)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=330) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f'ddp workers exited {codes}')
    with open(out) as f:
        obs = json.load(f)
    os.remove(out)
    obs['setup_s'] = obs.pop('window_start_age') - (common.boot_clock() - common.process_age())
    return obs


def worker(ctx, out):
    import torch.distributed as dist

    from margipose_tpu_torch.parallel import mesh
    from margipose_tpu_torch.utils import init_algorithms

    cfg, wl = ctx.config, ctx.workload
    marks = [('start', common.process_age())]
    device = mesh.init_from_env(ctx.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    marks.append(('process group', common.process_age()))
    ctx.device = device
    host = dist.new_group(backend='gloo')
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    shards = traffic.shard(pool, world, rank)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    init_algorithms(deterministic=False)  # after the weights, as the train cell
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(('weights', common.process_age()))
    state, step, feed = train.program(ctx, state_dict, shards)
    marks.append(('program', common.process_age()))
    got = train.judged_steps(state, step, feed, wl['warm_steps'])
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    marks.append(('warm steps', common.process_age()))
    preds = [None] * world
    dist.all_gather_object(preds, got['pred'], group=host)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    dist.barrier(group=host)
    marks.append(('gathered', common.process_age()))
    if rank == 0:
        common.log_marks(marks)

    flag = torch.zeros(1, dtype=torch.int32)
    i = wl['warm_steps']
    start_age = common.boot_clock()
    t0 = time.perf_counter()
    while True:
        flag[0] = int(time.perf_counter() - t0 >= ctx.seconds)
        dist.broadcast(flag, 0, group=host)
        if flag[0]:
            break
        step(state, feed(i))
        i += 1
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    dist.barrier(group=host)
    window_s = time.perf_counter() - t0
    steps = i - wl['warm_steps']
    obs = {'window_start_age': start_age, 'window_s': window_s, 'steps': steps,
           'images': steps * ctx.traffic['batch'], 'attempted': steps, 'failed': 0}
    obs['e2e'] = {wl['metric']: obs['images'] / window_s}
    if ctx.trace:
        n = wl['trace_steps']
        with trace.profiled(device) if rank == 0 else contextlib.nullcontext({}) as traced:
            for k in range(n):
                with trace.span('upload', rank == 0):
                    batch = feed(i + k)
                with trace.span('train_step', rank == 0):
                    step(state, batch)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        if rank == 0:
            traced['steps'] = n
            obs['trace'] = traced
    peaks = [None] * world
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    dist.all_gather_object(peaks, peak, group=host)
    obs['memory_peak_bytes'] = max(peaks)
    del state, step, feed
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    if rank == 0:
        got['pred'] = torch.cat([torch.as_tensor(p) for p in preds]).numpy()
        ref = train.reference_readout(train.reference_model(cfg, state_dict, device), pool,
                                      wl, device)
        obs['readings'], obs['notes'] = compare.train_readings(got, ref)
        obs['costs'] = {'flops_per_image': cfg['flops_per_image'], 'passes_per_image': 3,
                        'peak_flops': costs.PEAK_FLOPS[wl['precision']] * world,
                        'loss_head_rows': costs.loss_head_rows(cfg, ctx.traffic['batch'] // world),
                        'heatmap': cfg['heatmap_size']}
        with open(out, 'w') as f:
            json.dump(obs, f)
    dist.barrier(group=host)
    mesh.shutdown()


def main(argv=None):
    parser = argparse.ArgumentParser(description='one data-parallel worker of a ddp cell')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--out', required=True)
    parser.add_argument('--overrides', help='JSON: test-sized config and traffic entries')
    parser.add_argument('--fault', help='a fault of benchmark/faults.py to plant')
    args = parser.parse_args(argv)
    common.set_cache_dirs()
    from benchmark import run as harness

    ctx = harness.context(common.load_json('workloads', args.workload), args.seed,
                          args.seconds, bool(args.trace), torch.device(args.device))
    if args.overrides:
        harness.apply_overrides(ctx, json.loads(args.overrides))
    with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
        worker(ctx, args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
