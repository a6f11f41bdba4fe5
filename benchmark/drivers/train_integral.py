"""Training steps of the integral model on one card: what training the
volumetric-heatmap baseline costs.

As ``drivers/train.py`` runs the flagship: set-up makes the seeded weights,
loads them into the port's model (``models/integral.IntegralPoseModel``,
through the factory), builds one train state with 1cycle SGD and the step
(``train/steps.make_train_step``, which takes the model's own L1 loss), and
drives that state through its first ``warm_steps`` steps on the seeded
pool's batches, uploaded as ``data/specs.device_input`` ships them (``ship``
'uint8'). The first three are the ones judged. The window then steps the
same state until ``--seconds`` of host time have passed and ends in a
``torch.cuda.synchronize()``: ``train_images_per_s`` is every image it
trained over its whole time. The window's last loss is noted, not compared.

A program whose factory has no integral model raises when the port's model
is made, a few seconds in.

After the window, with the program's state freed, the plain reference
(``reference/integral.py``: float32, TF32 off) steps the same seeded
weights through the same three batches with the same 1cycle SGD, and
``compare.train_readings`` judges the losses, the first step's coordinates,
the first gradient and the change of the parameters after three steps.
"""

import math
import time

import torch

from benchmark import common, compare, costs, trace, traffic, weights
from benchmark.drivers.train import JUDGED, _norms, _ref_feed, judged_steps, reference_model
from benchmark.reference import integral, sgd


def reference_readout(model, pool, workload, device):
    """The plain integral step's losses, first gradient and change by leaf
    over the first three batches of ``pool``, from ``model``'s weights."""
    opt = workload['optimiser']
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    optimiser = sgd.OneCycleSGD(params.values(), opt['lr'], opt['max_iters'])
    losses, grad, pred = [], None, None
    for i in range(JUDGED):
        loss, xyz = integral.train_step(model, optimiser, _ref_feed(pool[i], device))
        losses.append(float(loss))
        if i == 0:
            grad = _norms(dict(zip(params, optimiser.buffers)))
            pred = xyz.cpu().numpy()
    change = _norms({k: p.detach() - start[k] for k, p in params.items()})
    return {'losses': losses, 'pred': pred, 'grad': grad, 'change': change}


def program(ctx, state_dict, pool):
    """The port's train state and step, and a feed of the pool's batches."""
    from margipose_tpu_torch.data.specs import device_input, to_device
    from margipose_tpu_torch.models import data_specs_for_desc
    from margipose_tpu_torch.train import steps
    from margipose_tpu_torch.train.schedules import make_optimiser

    wl, device = ctx.workload, ctx.device
    model = common.port_model(ctx.config, state_dict, device)
    opt = wl['optimiser']
    state = steps.TrainState(model, make_optimiser('1cycle', model.parameters(), opt['lr'],
                                                   max_iters=opt['max_iters']))
    step = steps.make_train_step(compute_dtype=wl['precision'])
    ship = data_specs_for_desc(ctx.config['model_desc']).input_specs
    ship = ship if wl['ship'] == 'uint8' else None

    def feed(i):
        batch = pool[i % len(pool)]
        pixels = batch['pixels'] if ship is not None else traffic.normalised(batch['pixels'])
        return {'input': device_input(pixels, device, ship),
                'target': to_device(batch['target'], device),
                'joint_mask': to_device(batch['joint_mask'], device),
                'valid_depth': to_device(batch['valid_depth'], device)}

    return state, step, feed


def kernel_costs(ctx):
    """What the soft-argmax kernels' byte bounds read
    (``costs_softargmax3d``): volumes a step, voxels a volume, bytes a logit."""
    cfg = ctx.config
    side = cfg['heatmap_size']
    return {'rows': ctx.traffic['batch'] * cfg['n_joints'],
            'volume': cfg['depth_dim'] * side * side,
            'width': 2 if ctx.workload['precision'] == 'bfloat16' else 4}


def run(ctx):
    from margipose_tpu_torch.utils import init_algorithms

    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    marks = [('imports', common.process_age())]
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    init_algorithms(deterministic=False)  # the train bin's policy: cuDNN's timed search
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
    last = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        last = step(state, feed(i))
        i += 1
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    steps = i - wl['warm_steps']
    obs = {'setup_s': setup_s, 'window_s': window_s, 'steps': steps,
           'images': steps * ctx.traffic['batch'], 'attempted': steps, 'failed': 0}
    obs['e2e'] = {wl['metric']: obs['images'] / window_s}
    last_loss = float(last['loss']) if last is not None else math.nan
    obs['notes'] = {'window_last_loss': last_loss}
    common.log(f'window: {steps} steps of {ctx.traffic["batch"]} in {window_s:.3f} s, '
               f'last loss {last_loss}')

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
    del state, step, feed, last
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    ref = reference_readout(reference_model(cfg, state_dict, device), pool, wl, device)
    obs['readings'], worst = compare.train_readings(got, ref)
    obs['notes'].update(worst)
    obs['costs'] = {'flops_per_image': cfg['flops_per_image'], 'passes_per_image': 3,
                    'peak_flops': costs.PEAK_FLOPS[wl['precision']] * wl['chips'],
                    'softargmax3d': kernel_costs(ctx)}
    return obs


def control(ctx, fmt):
    """The readings of the reference rounded to ``fmt`` in the program's place."""
    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    low = reference_readout(reference_model(cfg, state_dict, device, fmt), pool, wl, device)
    for part in ('grad', 'change'):
        low[part] = {k.replace('.parametrizations.weight.original', '.weight'): v
                     for k, v in low[part].items()}
    ref = reference_readout(reference_model(cfg, state_dict, device), pool, wl, device)
    compared, worst = compare.train_readings(low, ref)
    return dict(compared, **worst)
