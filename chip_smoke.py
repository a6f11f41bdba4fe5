#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (margipose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device        the card's name and power limit (nvidia-smi);
  2. build         every kernel in margipose_tpu_torch/csrc/, one nvcc per
                   source;
  3. kernels       each kernel against its plain PyTorch version on the card,
                   at the shapes the main paths give it, with times and
                   bounds; the head's autograd through the CUDA backward
                   against autograd through the plain version;
  4. main          the flagship eval path through its entry point
                   (margipose_tpu_torch.bin.eval_3d.main): MargiPose v6.0.1,
                   InceptionV4, 4 stages, 256 px, 17 joints, seeded random
                   weights, synthetic-64 at batch 32, float32 with TF32 off;
                   every kernel of the path must have launched;
  5. trace         torch.profiler over one eval batch: device time by kernel
                   group;
  6. parity        the eval forward on the card against the CPU;
  7. train         the flagship train path through its entry point
                   (margipose_tpu_torch.bin.train_3d.main): synthetic data at
                   batch 32, a few 1cycle steps and one validation batch, a
                   model-latest checkpoint, which bin.eval_3d then reads;
                   both kernels must have launched 12 times a step;
  8. train trace   torch.profiler over one train step at batch 32;
  9. train parity  one train step at batch 2 on the card against the CPU.
Then one JSON line of per-kernel numbers, and last the result line
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
ATOL_KERNEL = 1e-5         # float32 sums in another order than torch's reductions
# dp is O(1) (grid coordinates and log ratios); the kernel's logs and
# contracted multiply-adds round apart from torch's by a few ulp
ATOL_GRAD = 1e-5
KERNEL_SHAPES = [(1, 17, 32, 32, 1.0), (32, 17, 32, 32, 1.0), (1, 13, 16, 24, 2.0)]
MAIN_SHAPE = (32, 32, 32)  # the main paths' (B, H, W): batch 32, 17 joints
PALLAS = 'margipose_tpu/ops/pallas_dsnt.py'
TRAIN_STEPS = 4            # the train path's steps at batch 32


def phase(name, msg):
    print(f'[{name}] {msg}', flush=True)


def median_ms(fn, reps=20, samples=25):
    """Median over ``samples`` of the CUDA-event time of ``reps`` back-to-back
    calls, per call, after a warm-up. Eager: includes each call's launch cost."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def graph_ms(fn, reps=20, samples=25):
    """Device time per call with the host out of the way: ``reps`` calls
    captured in one CUDA graph, replayed; median over ``samples``."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return median_ms(graph.replay, reps=1, samples=samples) / reps


def device_phase():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    phase('device', f'torch.cuda: {name}, count {torch.cuda.device_count()}, '
                    f'torch {torch.__version__}, CUDA {torch.version.cuda}')
    print(smi, flush=True)
    return name, smi


def build_phase():
    from margipose_tpu_torch.ops import _build

    names = _build.kernel_sources()
    t0 = time.perf_counter()
    _build.build(names)
    phase('build', f'{names} built in {time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}')


def dsnt_jsd_inputs(b, j, h, w, seed):
    from margipose_tpu_torch.ops.dsnt import flat_softmax

    g = torch.Generator().manual_seed(seed)
    p = flat_softmax(torch.randn(b, j, h, w, generator=g) * 2).cuda()
    mu = (torch.rand(b, j, 2, generator=g) * 1.6 - 0.8).cuda()
    return p, mu


def bound(bytes_moved, ops):
    """(least ms the card could take, what bounds it): each input read once,
    each output written once, at the HBM rate; the operations at the float32
    rate outside the tensor cores."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def kernel_phase():
    """dsnt_jsd_fused against dsnt_jsd_plain at the flagship rows (B=1 and
    the main path's B=32) and the non-square 16x24 case."""
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_fused, dsnt_jsd_plain

    report = dict(name='dsnt_jsd_fwd', route='cuda', source='margipose_tpu_torch/csrc/dsnt_jsd.cu',
                  replaces=f'{PALLAS}:62', library_ms=None)
    worst = 0.0
    for b, j, h, w, sigma in KERNEL_SHAPES:
        p, mu = dsnt_jsd_inputs(b, j, h, w, seed=b * 1000 + h)
        coords, jsd = dsnt_jsd_fused(p, mu, sigma)
        exp_coords, exp_jsd = dsnt_jsd_plain(p, mu, sigma)
        torch.cuda.synchronize()
        err = max((coords - exp_coords).abs().max().item(), (jsd - exp_jsd).abs().max().item())
        if not err <= ATOL_KERNEL:
            raise AssertionError(f'dsnt_jsd kernel disagrees with its plain version at '
                                 f'{(b, j, h, w)}: max abs err {err} > {ATOL_KERNEL}')
        worst = max(worst, err)
        rows, s = b * j, h * w
        # p, mu read; out written. Per element: grid, q, m, 3 logs, 4 FMAs
        bound_ms, bound_by = bound(4 * (rows * s + rows * 2 + rows * 4), rows * s * 16)
        ms = median_ms(lambda: dsnt_jsd_fused(p, mu, sigma))
        dev_ms = graph_ms(lambda: dsnt_jsd_fused(p, mu, sigma))
        plain_ms = median_ms(lambda: dsnt_jsd_plain(p, mu, sigma))
        phase('kernels', f'dsnt_jsd_fwd {b}x{j}x{h}x{w} sigma={sigma}: max abs err {err:.3g} '
                         f'(atol {ATOL_KERNEL}); kernel {ms * 1e3:.2f} us per call eager, '
                         f'{dev_ms * 1e3:.2f} us in a CUDA graph; plain {plain_ms * 1e3:.2f} us; '
                         f'bound {bound_ms * 1e3:.3f} us ({bound_by}); library n/a')
        if (b, h, w) == MAIN_SHAPE:
            report.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    report['max_abs_err'] = worst
    return report


def backward_kernel_phase():
    """dsnt_jsd_bwd against dsnt_jsd_bwd_plain at the forward's shapes, and
    the gradient of flat_softmax -> dsnt_jsd_fused (whose backward is the
    kernel) against that of flat_softmax -> dsnt_jsd_plain (torch autograd),
    with no gradient reaching the targets."""
    from margipose_tpu_torch.ops.dsnt import flat_softmax
    from margipose_tpu_torch.ops.dsnt_jsd import (
        dsnt_jsd_bwd,
        dsnt_jsd_bwd_plain,
        dsnt_jsd_fused,
        dsnt_jsd_plain,
    )

    report = dict(name='dsnt_jsd_bwd', route='cuda', source='margipose_tpu_torch/csrc/dsnt_jsd.cu',
                  replaces=f'{PALLAS}:79', library_ms=None)
    worst = 0.0
    for b, j, h, w, sigma in KERNEL_SHAPES:
        p, mu = dsnt_jsd_inputs(b, j, h, w, seed=b * 1000 + h + 1)
        g = torch.Generator().manual_seed(b + h)
        grad = torch.randn(b * j, 4, generator=g).cuda()
        dp = dsnt_jsd_bwd(p, mu, grad, sigma)
        expected = dsnt_jsd_bwd_plain(p, mu, grad, sigma)
        torch.cuda.synchronize()
        err = (dp - expected).abs().max().item()

        logits = (torch.randn(b, j, h, w, generator=g) * 2).cuda()
        weights = torch.randn(b, j, 3, generator=g).cuda()
        grads = []
        for head in (dsnt_jsd_fused, dsnt_jsd_plain):
            lg = logits.clone().requires_grad_()
            target = mu.clone().requires_grad_()
            coords, jsd = head(flat_softmax(lg), target, sigma)
            loss = (coords * weights[..., :2]).sum() + (jsd * weights[..., 2]).sum()
            grads.append(torch.autograd.grad(loss, (lg, target), allow_unused=True))
        (d_logits, d_mu), (plain_logits, _) = grads
        autograd_err = (d_logits - plain_logits).abs().max().item()
        if not (err <= ATOL_GRAD and autograd_err <= ATOL_GRAD):
            raise AssertionError(f'dsnt_jsd_bwd disagrees with its plain version at '
                                 f'{(b, j, h, w)}: max abs err {err}, through the softmax '
                                 f'{autograd_err} (atol {ATOL_GRAD})')
        if not (d_mu is None or torch.count_nonzero(d_mu).item() == 0):
            raise AssertionError('dsnt_jsd_fused passed a gradient to its targets')
        worst = max(worst, err, autograd_err)
        rows, s = b * j, h * w
        # p, mu, grad read; dp written. Per element: grid, q, m, 2 logs, 3 FMAs
        bound_ms, bound_by = bound(4 * (2 * rows * s + rows * 2 + rows * 4), rows * s * 16)
        ms = median_ms(lambda: dsnt_jsd_bwd(p, mu, grad, sigma))
        dev_ms = graph_ms(lambda: dsnt_jsd_bwd(p, mu, grad, sigma))
        plain_ms = median_ms(lambda: dsnt_jsd_bwd_plain(p, mu, grad, sigma))
        phase('kernels', f'dsnt_jsd_bwd {b}x{j}x{h}x{w} sigma={sigma}: max abs err {err:.3g}, '
                         f'through the softmax {autograd_err:.3g} (atol {ATOL_GRAD}), target '
                         f'gradient {"none" if d_mu is None else "zero"}; kernel '
                         f'{ms * 1e3:.2f} us per call eager, {dev_ms * 1e3:.2f} us in a CUDA '
                         f'graph; plain {plain_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us '
                         f'({bound_by}); library n/a')
        if (b, h, w) == MAIN_SHAPE:
            report.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    report['max_abs_err'] = worst
    return report


def launch_counters():
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_bwd, dsnt_jsd_fused

    return {'dsnt_jsd_fwd': dsnt_jsd_fused, 'dsnt_jsd_bwd': dsnt_jsd_bwd}


@torch.no_grad()
def randomize_batch_norm(model, images, generator):
    """BN running stats from one train-mode pass over ``images``, perturbed
    at random; the last residual block of every column scaled down, so the
    heatmaps are neither flat nor one-hot (as with trained weights)."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one pass gives the batch stats
    model.train()(images)
    model.eval()
    for bn in bns:
        bn.momentum = 0.1
        n = bn.num_features
        bn.running_mean += 0.05 * torch.randn(n, generator=generator).to(bn.running_mean)
        bn.running_var *= (0.8 + 0.45 * torch.rand(n, generator=generator)).to(bn.running_var)
    for plane in ('xy', 'zy', 'xz'):
        for column in getattr(model.inner, f'{plane}_hm_cnns'):
            last = column.up_layers[4]
            for bn in (last.module[4], last.shortcut[1]):
                bn.weight *= 0.5
                bn.bias *= 0.5


def flagship(device):
    from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model

    g = torch.Generator().manual_seed(0)
    model = create_model(Default_MargiPose_Desc, generator=g).to(device)
    randomize_batch_norm(model, torch.randn(8, 3, 256, 256, generator=g).to(device), g)
    return model


def main_path_phase(model):
    from margipose_tpu_torch.bin import eval_3d
    from margipose_tpu_torch.checkpoint import save_model
    from margipose_tpu_torch.models import Default_MargiPose_Desc

    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, 'margipose-flagship-random.pth')
    save_model(ckpt, model, Default_MargiPose_Desc)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    rows, stats = eval_3d.main(['--model', ckpt, '--dataset', 'synthetic-64',
                                '--batch-size', '32', '--device', 'cuda'])
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = 12 * stats['batches']  # 3 planes x 4 stages per batch
    phase('main', f"kernel launches {launches}, expected dsnt_jsd_fwd = 12 x "
                  f"{stats['batches']} batches = {expected}")
    if launches != {'dsnt_jsd_fwd': expected, 'dsnt_jsd_bwd': 0} or expected == 0:
        raise AssertionError(f'eval path launched {launches}, expected dsnt_jsd_fwd {expected} '
                             f'and no dsnt_jsd_bwd')
    ms = [s * 1e3 for s in stats['batch_seconds']]
    phase('main', f'device ms per batch of 32: {", ".join(f"{m:.3f}" for m in ms)}; '
                  f'{32 * len(ms) / (sum(ms) / 1e3):.1f} images/s; '
                  f'mean loss {stats["mean_loss"]}')
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == 64):
        raise AssertionError('main path gave non-finite metrics or loss, or lost examples')
    phase('main', f'loss and coordinates finite; overall {eval_3d.overall_metrics(rows)}')
    return launches, ms


def profiled(fn):
    """One call of ``fn`` (after a warm-up) timed by CUDA events alone, and
    one under torch.profiler: (device kernel events by name, the kernels'
    busy ms, the unprofiled window's ms). The profiler adds host time to
    every launch, so only the unprofiled window says how long the device
    waits for the host. The events are empty where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return events, busy_ms, start.elapsed_time(end)


def kernel_ms(events, words):
    return sum(e.self_device_time_total for e in events
               if any(w in e.key.lower() for w in words)) / 1e3


# cuDNN's convolution kernels: implicit GEMM, FFT (r2c, pointwise complex
# product, c2r), dgrad (also the transposed convolution's forward) and wgrad
CONV_WORDS = ('conv', 'gemm', 'xmma', 'fft', 'complex', 'dgrad', 'wgrad')


def report_trace(name, what, events, busy_ms, window_ms, groups):
    if not events:
        phase(name, f'{what}: window {window_ms:.3f} ms; kernel times not measured '
                    '(the profiler reported no device events)')
        return
    phase(name, f'{what}: window {window_ms:.3f} ms (CUDA events, no profiler), kernels busy '
                f'{busy_ms:.3f} ms (profiler), idle share {max(0.0, 1 - busy_ms / window_ms):.1%}; '
                f'{len(events)} kernel names, {sum(e.count for e in events)} launches')
    phase(name, '; '.join(f'{label} {ms:.3f} ms ({ms / busy_ms:.1%})'
                          for label, ms in ((label, kernel_ms(events, words))
                                            for label, words in groups)))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        phase(name, f'  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:110]}')


def flagship_batch(b, seed):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(b, 17)
    mask[-1, 4] = 0
    return {'input': torch.randn(b, 3, 256, 256, generator=g),
            'target': torch.rand(b, 17, 3, generator=g) * 1.6 - 0.8,
            'joint_mask': mask,
            'valid_depth': torch.tensor([1, 0] * (b // 2))}


def trace_phase(model):
    """Where one batch of 32 spends its device time: torch.profiler over one
    forward + masked loss, kernels grouped by name."""
    from margipose_tpu_torch.models.margipose import margipose_masked_loss

    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=2).items()}

    def step():
        with torch.inference_mode():
            margipose_masked_loss(model(batch['input'])[1], batch['target'], batch['joint_mask'],
                                  batch['valid_depth'])

    report_trace('trace', 'one batch of 32, forward + loss', *profiled(step),
                 [('convolutions', CONV_WORDS), ('batch norm', ('batch_norm', 'bn_')),
                  ('dsnt_jsd head', ('dsnt_jsd',)), ('softmax', ('softmax',))])


def parity_phase(model):
    """The port on the card against the port on the CPU, float32, TF32 off."""
    from margipose_tpu_torch.models.margipose import margipose_masked_loss

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 256, 256, generator=g)
    target = torch.rand(2, 17, 3, generator=g) * 1.6 - 0.8
    mask = torch.ones(2, 17)
    mask[1, 4] = 0
    valid_depth = torch.tensor([1, 0])
    cpu_model = copy.deepcopy(model).cpu()
    results = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        with torch.inference_mode():
            xyz, out = m(x.to(dev))
            loss = margipose_masked_loss(out, target.to(dev), mask.to(dev), valid_depth.to(dev))
        results.append(([h.cpu() for hms in out for h in hms], float(loss), xyz.cpu()))
    (hm_gpu, loss_gpu, _), (hm_cpu, loss_cpu, _) = results
    hm_err = max((a - b).abs().max().item() for a, b in zip(hm_gpu, hm_cpu))
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    peak = max(h.max().item() for h in hm_cpu)
    phase('parity', f'card vs CPU: heatmaps max abs err {hm_err:.3g} (atol 1e-4, peak value '
                    f'{peak:.3f}), loss {loss_gpu:.6f} vs {loss_cpu:.6f}, rel err {loss_rel:.3g} '
                    f'(rtol 1e-3)')
    if not (hm_err <= 1e-4 and loss_rel <= 1e-3):
        raise AssertionError('the port on the card disagrees with the port on the CPU')


def train_path_phase():
    """The flagship train path through its entry point: MargiPose v6.0.1 at
    full width and depth from seeded random weights, synthetic-512 at batch
    32 with augmentation, TRAIN_STEPS 1cycle steps and one validation batch,
    then bin.eval_3d on the checkpoint the run wrote."""
    from margipose_tpu_torch.bin import eval_3d, train_3d
    from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model
    from margipose_tpu_torch.train import checkpoint

    out_dir = os.path.join(WORK, 'train')
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, val_batches, seed = TRAIN_STEPS, 1, 7
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    result = train_3d.main(['with', 'margipose_model', 'synthetic', 'epochs=1', 'batch_size=32',
                            f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']",
                            'val_examples=32', 'metrics_every=1', f'seed={seed}',
                            f'out_dir={out_dir}', 'experiment_id=flagship'])
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {'dsnt_jsd_fwd': 12 * (steps + val_batches), 'dsnt_jsd_bwd': 12 * steps}
    phase('train', f'kernel launches {launches}, expected {expected} (12 a step: 3 planes x 4 '
                   f'stages; {steps} train steps, {val_batches} validation batch)')
    if launches != expected or result['step'] != steps:
        raise AssertionError(f'train path launched {launches} in {result["step"]} steps, '
                             f'expected {expected} in {steps}')

    ckpt_dir = os.path.join(out_dir, 'flagship', 'model-latest')
    saved = checkpoint.load_payload(ckpt_dir)['model']
    initial = create_model(Default_MargiPose_Desc,
                           generator=torch.Generator().manual_seed(seed)).state_dict()
    weights = [k for k in initial if k.endswith('weight')]
    changed = sum(not torch.equal(saved[k], initial[k]) for k in weights)
    with open(os.path.join(out_dir, 'flagship', 'metrics.jsonl')) as f:
        record = json.loads(f.readline())
    losses = [result['train_loss'], record['val_loss']]
    if not (all(math.isfinite(v) for v in losses) and changed == len(weights)):
        raise AssertionError(f'train path: losses {losses}, {changed} of {len(weights)} '
                             f'weight tensors changed')
    ms = [s * 1e3 for s in result['step_seconds']]
    steady = ms[1:]  # the first step includes cuDNN's algorithm search
    phase('train', f'train loss {result["train_loss"]:.6f}, val loss {record["val_loss"]:.6f}, '
                   f'{changed} of {len(weights)} weight tensors changed; model-latest written')
    phase('train', f'device ms per step of 32: {", ".join(f"{m:.3f}" for m in ms)}; '
                   f'{32 * len(steady) / (sum(steady) / 1e3):.1f} images/s on the device '
                   f'after the first step; {result["train_images_per_sec"]:.1f} images/s by the '
                   f'host clock (window meter); data_load_time {result["data_load_time"]:.4f} s '
                   f'a step; peak memory {peak_gib:.2f} GiB (max_memory_allocated)')

    rows, stats = eval_3d.main(['--model', ckpt_dir, '--dataset', 'synthetic-64',
                                '--batch-size', '32', '--device', 'cuda'])
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == 64):
        raise AssertionError('eval of the trained checkpoint gave non-finite metrics or loss')
    phase('train', f'bin.eval_3d on model-latest: overall {eval_3d.overall_metrics(rows)}, '
                   f'mean loss {stats["mean_loss"]}')
    return launches


def train_trace_phase(model):
    """Where one flagship train step at batch 32 spends its device time:
    torch.profiler over the port's train step, and over its forward + loss
    alone (train mode, no autograd graph: the same kernels), so that the
    backward's share is the difference."""
    from margipose_tpu_torch.models.margipose import margipose_masked_loss
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    model = copy.deepcopy(model)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, max_iters=100))
    step = make_train_step('jsd')
    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=5).items()}
    step(state, batch)  # cuDNN's algorithm search for the train shapes

    def forward():
        with torch.no_grad():
            margipose_masked_loss(model.train()(batch['input'])[1], batch['target'],
                                  batch['joint_mask'], batch['valid_depth'])

    groups = [('convolutions', CONV_WORDS), ('batch norm', ('batch_norm', 'bn_')),
              ('dsnt_jsd_fwd', ('dsnt_jsd_fwd',)), ('dsnt_jsd_bwd', ('dsnt_jsd_bwd',)),
              ('softmax', ('softmax',)), ('optimiser', ('multi_tensor', 'foreach', 'sgd'))]
    fwd_events, fwd_busy, fwd_window = profiled(forward)
    events, busy, window = profiled(lambda: step(state, batch))
    report_trace('train trace', 'forward + loss alone, batch 32', fwd_events, fwd_busy,
                 fwd_window, groups[:2])
    report_trace('train trace', 'one train step of 32', events, busy, window, groups)
    if events and fwd_events:
        bwd_conv = kernel_ms(events, CONV_WORDS) - kernel_ms(fwd_events, CONV_WORDS)
        bwd_bn = kernel_ms(events, groups[1][1]) - kernel_ms(fwd_events, groups[1][1])
        rest = busy - sum(kernel_ms(events, words) for _, words in groups)
        phase('train trace', f'backward + optimiser {busy - fwd_busy:.3f} ms of kernels: '
                             f'convolutions {bwd_conv:.3f} ms (dgrad, wgrad), batch norm '
                             f'{bwd_bn:.3f} ms; kernels in no group above {rest:.3f} ms '
                             f'(elementwise, ReLU, copies)')


def train_parity_phase(model):
    """One train step at batch 2 from the same weights and batch on the card
    and on the CPU, float32, TF32 off. Tolerances:
      loss        rtol 1e-3, as the eval parity;
      parameters  1e-4 + 2% of the largest update the CPU step made to the
                  tensor: train-mode batch norm over few values a channel
                  amplifies rounding (tests/test_torch_train_step.py measures
                  the port's float32 step 1% of the update away from its
                  float64 step at 2 stages, 64 px);
      BN buffers  rtol 1e-4, atol 1e-5."""
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    batch = flagship_batch(2, seed=3)
    initial = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    results = {}
    for dev in ('cuda', 'cpu'):
        m = copy.deepcopy(model).to(dev)
        state = TrainState(m, make_optimiser('1cycle', m.parameters(), 1.0, max_iters=10))
        metrics = make_train_step('jsd')(state, {k: v.to(dev) for k, v in batch.items()})
        results[dev] = (float(metrics['loss']),
                        {k: v.detach().cpu() for k, v in m.state_dict().items()})
    (loss_gpu, gpu), (loss_cpu, cpu) = results['cuda'], results['cpu']
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst_param, worst_buffer = (0.0, ''), (0.0, '')
    for key, want in cpu.items():
        err = (gpu[key].double() - want.double()).abs()
        if key.endswith('num_batches_tracked'):
            continue
        if 'running_' in key:
            ratio = (err / (1e-5 + 1e-4 * want.double().abs())).max().item()
            worst_buffer = max(worst_buffer, (ratio, key))
        else:
            update = (want - initial[key]).abs().max().item()
            worst_param = max(worst_param, (err.max().item() / (1e-4 + 0.02 * update), key))
    phase('train parity', f'one step at batch 2, card vs CPU: loss {loss_gpu:.6f} vs '
                          f'{loss_cpu:.6f}, rel err {loss_rel:.3g} (rtol 1e-3); worst parameter '
                          f'at {worst_param[0]:.3g} of its tolerance ({worst_param[1]}); worst BN '
                          f'buffer at {worst_buffer[0]:.3g} of its tolerance ({worst_buffer[1]})')
    if not (loss_rel <= 1e-3 and worst_param[0] <= 1 and worst_buffer[0] <= 1):
        raise AssertionError('a train step on the card disagrees with one on the CPU')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card',
              file=sys.stderr)
        return 1
    kind, _ = device_phase()
    build_phase()
    kernels = [kernel_phase(), backward_kernel_phase()]
    torch.cuda.synchronize()
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode

    set_float32_parity_mode()
    model = flagship('cuda')
    eval_launches, _ = main_path_phase(model)
    trace_phase(model)
    parity_phase(model)
    train_launches = train_path_phase()
    train_trace_phase(model)
    train_parity_phase(model)
    for k in kernels:
        # launches: the train path's, which runs both kernels
        k['launches'] = train_launches[k['name']]
        k['launches_by_path'] = {'eval': eval_launches[k['name']],
                                 'train': train_launches[k['name']]}
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
