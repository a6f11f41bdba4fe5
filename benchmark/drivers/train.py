"""Training steps on one card: what training a configuration costs.

Set-up makes the seeded weights, loads them into the port's model, builds
one train state (``train/steps.TrainState`` with ``train/schedules.
make_optimiser('1cycle', ...)``, as the train bin builds it) and the step
(``train/steps.make_train_step``), and drives that state through its first
``warm_steps`` steps through the window's own call and feed: each batch
from the seeded host pool in turn, up through ``data/specs.device_input``
(``ship`` 'uint8': the train bin's uint8 upload). The first three are the
ones judged; the first includes cuDNN's timed search (the train bin's
``init_algorithms`` policy). The window then steps the same state on the
pool's next batches until ``--seconds`` of host time have passed and ends in
a ``torch.cuda.synchronize()``: ``train_images_per_s`` is every image it
trained over its whole time.

After the window, with the program's state freed, the plain reference
(float32, TF32 off) steps the same seeded weights through the same three
batches with the same 1cycle SGD, and ``compare.train_readings`` judges the
program's losses, its first step's coordinates, its first gradient (its
momentum buffers after one step) and the change of its parameters after
three.
"""

import time

import numpy as np
import torch

from benchmark import common, compare, costs, trace, traffic, weights
from benchmark.reference import build, inputs, sgd
from benchmark.reference.lowp import lower_precision

JUDGED = 3


def _norms(named):
    names = list(named)
    values = torch.stack([t.detach().float().norm() for t in named.values()]).cpu().numpy()
    return dict(zip(names, values.astype(np.float64).tolist()))


def _ref_feed(batch, device):
    return {'input': inputs.normalise(torch.from_numpy(batch['pixels']).to(device)),
            'target': torch.from_numpy(batch['target']).to(device),
            'joint_mask': torch.from_numpy(batch['joint_mask']).to(device),
            'valid_depth': torch.from_numpy(batch['valid_depth']).to(device)}


def reference_readout(model, pool, workload, device):
    """The plain step's losses, first gradient and change by leaf over the
    first three batches of ``pool``, from ``model``'s present weights."""
    opt = workload['optimiser']
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    optimiser = sgd.OneCycleSGD(params.values(), opt['lr'], opt['max_iters'])
    losses, grad, pred = [], None, None
    for i in range(JUDGED):
        loss, xyz = sgd.train_step(model, optimiser, _ref_feed(pool[i], device))
        losses.append(float(loss))
        if i == 0:
            grad = _norms(dict(zip(params, optimiser.buffers)))
            pred = xyz.cpu().numpy()
    change = _norms({k: p.detach() - start[k] for k, p in params.items()})
    return {'losses': losses, 'pred': pred, 'grad': grad, 'change': change}


def reference_model(config, state_dict, device, fmt=None):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.device('meta'):
        model = build(config['reference'])
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model if fmt is None else lower_precision(model, fmt)


def program(ctx, state_dict, pool):
    """The port's train state and step, and a feed of the pool's batches."""
    from margipose_tpu_torch.data.specs import device_input, to_device
    from margipose_tpu_torch.models import data_specs_for_desc
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    desc, wl, device = ctx.config['model_desc'], ctx.workload, ctx.device
    model = common.port_model(ctx.config, state_dict, device)
    opt = wl['optimiser']
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), opt['lr'],
                                             max_iters=opt['max_iters']))
    step = make_train_step(desc['settings']['pixelwise_loss'], compute_dtype=wl['precision'])
    ship = data_specs_for_desc(desc).input_specs if wl['ship'] == 'uint8' else None

    def feed(i):
        batch = pool[i % len(pool)]
        pixels = batch['pixels'] if ship is not None else traffic.normalised(batch['pixels'])
        return {'input': device_input(pixels, device, ship),
                'target': to_device(batch['target'], device),
                'joint_mask': to_device(batch['joint_mask'], device),
                'valid_depth': to_device(batch['valid_depth'], device)}

    return state, step, feed


def judged_steps(state, step, feed, warm_steps):
    """Run the set-up's steps; the readout of the first three."""
    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grad, change, pred = [], None, None, None
    for i in range(warm_steps):
        out = step(state, feed(i))
        if i < JUDGED:
            losses.append(out['loss'])
        if i == 0:
            pred = out['pred'].float().cpu().numpy()
            opt_state = state.optimiser.optimiser.state
            grad = _norms({k: opt_state[p]['momentum_buffer'] if 'momentum_buffer'
                           in opt_state.get(p, {}) else torch.zeros(())
                           for k, p in params.items()})
        if i == JUDGED - 1:
            change = _norms({k: p.detach() - start[k] for k, p in params.items()})
    del start
    return {'losses': [float(x) for x in losses], 'pred': pred, 'grad': grad, 'change': change}


def run(ctx):
    from margipose_tpu_torch.utils import init_algorithms

    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    marks = [('imports', common.process_age())]
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    # the train bin's policy, cuDNN's timed search, once the weights are
    # made: it warms the traffic's shapes, not the calibration's
    init_algorithms(deterministic=False)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(('pool and weights', common.process_age()))
    state, step, feed = program(ctx, state_dict, pool)
    got = judged_steps(state, step, feed, wl['warm_steps'])
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    setup_s = common.process_age()
    common.log_marks(marks + [('warm steps', setup_s)])

    i = wl['warm_steps']
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        step(state, feed(i))
        i += 1
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    steps = i - wl['warm_steps']
    obs = {'setup_s': setup_s, 'window_s': window_s, 'steps': steps,
           'images': steps * ctx.traffic['batch'], 'attempted': steps, 'failed': 0}
    obs['e2e'] = {wl['metric']: obs['images'] / window_s}
    common.log(f'window: {steps} steps of {ctx.traffic["batch"]} in {window_s:.3f} s')

    if ctx.trace:
        n = wl['trace_steps']
        with trace.profiled(device) as traced:
            for k in range(n):
                with trace.span('upload', True):
                    batch = feed(i + k)
                with trace.span('train_step', True):
                    step(state, batch)
        traced['steps'] = n
        obs['trace'] = traced
        common.log(f'trace: {n} steps, window {traced["window_s"]:.3f} s, busy '
                   f'{traced["busy_s"]:.3f} s, reduced in {traced["reduce_s"]:.1f} s')
    obs['memory_peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                if device.type == 'cuda' else 0)
    del state, step, feed
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    ref = reference_readout(reference_model(cfg, state_dict, device), pool, wl, device)
    obs['readings'], obs['notes'] = compare.train_readings(got, ref)
    obs['costs'] = {'flops_per_image': cfg['flops_per_image'],
                    'passes_per_image': 3,
                    'peak_flops': costs.PEAK_FLOPS[wl['precision']] * wl['chips'],
                    'loss_head_rows': costs.loss_head_rows(cfg, ctx.traffic['batch']),
                    'heatmap': cfg['heatmap_size']}
    return obs


def control(ctx, fmt):
    """The readings of the reference rounded to ``fmt`` in the program's place."""
    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    low = reference_readout(reference_model(cfg, state_dict, device, fmt), pool, wl, device)
    low['grad'] = {k.replace('.parametrizations.weight.original', '.weight'): v
                   for k, v in low['grad'].items()}
    low['change'] = {k.replace('.parametrizations.weight.original', '.weight'): v
                     for k, v in low['change'].items()}
    ref = reference_readout(reference_model(cfg, state_dict, device), pool, wl, device)
    compared, worst = compare.train_readings(low, ref)
    return dict(compared, **worst)
