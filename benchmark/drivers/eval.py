"""Evaluation batches on one card: what scoring a checkpoint costs.

Set-up makes the seeded weights and loads them into the port's model, sets
the eval bin's policies (``utils.init_algorithms(deterministic=True)``;
float32 with TF32 off through ``bin/eval_3d.set_float32_parity_mode``) and
builds ``bin/eval_3d.make_forward``: forward and masked loss. Each batch goes
up as ``data/specs.device_input`` ships it (``ship`` 'float32': the host's
normalised input, as ``--ship auto`` chooses for float32), from a seeded
pool taken in turn, and its coordinates and loss come back to the host
through pinned copies, at most ``drain_window`` batches in flight, as
``bin/eval_3d.obtain_predictions`` reads them. Two warm batches (the first
makes cuDNN's plans), then the window: batches until ``--seconds`` of host
time, and every result back. ``eval_images_per_s`` is every image of the
window over its whole time.

After the window, with the program's model freed, the plain reference
(float32, TF32 off) runs each pool batch, and every batch of the window is
judged against its pool batch's: the widest coordinate gap and the largest
relative loss gap.
"""

import collections
import time

import torch

from benchmark import common, compare, costs, trace, traffic, weights
from benchmark.drivers.train import reference_model
from benchmark.reference import inputs
from benchmark.reference.loss import masked_loss


def _host(t):
    if t.device.type == 'cuda':
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    return t.clone()


@torch.no_grad()
def reference_outputs(model, pool, device):
    """(coordinates, loss) of every pool batch from ``model``, in float32."""
    out = []
    for batch in pool:
        xyz, hms = model.eval()(inputs.normalise(torch.from_numpy(batch['pixels']).to(device)))
        loss = masked_loss(hms, torch.from_numpy(batch['target']).to(device),
                           torch.from_numpy(batch['joint_mask']).to(device),
                           torch.from_numpy(batch['valid_depth']).to(device))
        out.append((xyz.cpu().numpy(), float(loss)))
    return out


def readings(results, ref):
    """``results``: (pool index, coordinates, loss) of each judged batch."""
    return {'coord_gap': max(compare.widest(xyz, ref[i][0]) for i, xyz, _ in results),
            'loss_gap': max(compare.relative([loss], [ref[i][1]]) for i, _, loss in results)}


def run(ctx):
    from margipose_tpu_torch.bin.eval_3d import make_forward, set_float32_parity_mode
    from margipose_tpu_torch.data.specs import device_input, to_device
    from margipose_tpu_torch.models import data_specs_for_desc
    from margipose_tpu_torch.utils import init_algorithms

    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    marks = [('imports', common.process_age())]
    init_algorithms(deterministic=True)
    if wl['precision'] == 'float32':
        set_float32_parity_mode()
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    ship = data_specs_for_desc(cfg['model_desc']).input_specs if wl['ship'] == 'uint8' else None
    host = [b['pixels'] if ship is not None else traffic.normalised(b['pixels']) for b in pool]
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(('pool and weights', common.process_age()))
    model = common.port_model(cfg, state_dict, device)
    forward = make_forward(model, cfg['model_desc']['settings']['pixelwise_loss'],
                           wl['precision'])
    results, pending = [], collections.deque()
    traced = False

    def drain(entry):
        i, xyz, loss, done = entry
        if done is not None:
            done.synchronize()
        results.append((i, xyz.numpy(), float(loss)))

    def batch(k):
        i = k % len(pool)
        with trace.span('upload', traced):
            images = device_input(host[i], device, ship)
            target, mask, depth = (to_device(pool[i][f], device)
                                   for f in ('target', 'joint_mask', 'valid_depth'))
        with trace.span('forward', traced):
            xyz, loss = forward(images, target, mask, depth)
        with trace.span('readback', traced):
            done = None
            xyz_h, loss_h = _host(xyz), _host(loss)
            if device.type == 'cuda':
                done = torch.cuda.Event()
                done.record()
            pending.append((i, xyz_h, loss_h, done))
            if len(pending) > wl['drain_window']:
                drain(pending.popleft())

    def flush():
        while pending:
            drain(pending.popleft())

    for k in range(wl['warm_batches']):
        batch(k)
    flush()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    results.clear()
    setup_s = common.process_age()
    common.log_marks(marks + [('warm batches', setup_s)])

    k = wl['warm_batches']
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        batch(k)
        k += 1
    flush()
    window_s = time.perf_counter() - t0
    n = len(results)
    obs = {'setup_s': setup_s, 'window_s': window_s, 'steps': n,
           'images': n * ctx.traffic['batch'], 'attempted': n, 'failed': 0}
    obs['e2e'] = {wl['metric']: obs['images'] / window_s}
    common.log(f'window: {n} batches of {ctx.traffic["batch"]} in {window_s:.3f} s')

    if ctx.trace:
        traced = True
        with trace.profiled(device) as tr:
            for j in range(wl['trace_batches']):
                batch(k + j)
            flush()
        tr['steps'] = wl['trace_batches']
        obs['trace'] = tr
        common.log(f'trace: {tr["steps"]} batches, window {tr["window_s"]:.3f} s, busy '
                   f'{tr["busy_s"]:.3f} s, reduced in {tr["reduce_s"]:.1f} s')
    obs['memory_peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                if device.type == 'cuda' else 0)
    del model, forward
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    ref = reference_outputs(reference_model(cfg, state_dict, device), pool, device)
    obs['readings'] = readings(results, ref)
    obs['costs'] = {'flops_per_image': cfg['flops_per_image'], 'passes_per_image': 1,
                    'peak_flops': costs.PEAK_FLOPS[wl['precision']] * wl['chips'],
                    'loss_head_rows': costs.loss_head_rows(cfg, ctx.traffic['batch']),
                    'heatmap': cfg['heatmap_size']}
    return obs


def control(ctx, fmt):
    """The readings of the reference rounded to ``fmt`` in the program's place."""
    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    low = reference_outputs(reference_model(cfg, state_dict, device, fmt), pool, device)
    ref = reference_outputs(reference_model(cfg, state_dict, device), pool, device)
    return readings([(i, xyz, loss) for i, (xyz, loss) in enumerate(low)], ref)
