#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (margipose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    every kernel in margipose_tpu_torch/csrc/, one nvcc per source;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it, with times and bounds;
  4. main     the flagship eval path through its entry point
              (margipose_tpu_torch.bin.eval_3d.main): MargiPose v6.0.1,
              InceptionV4, 4 stages, 256 px, 17 joints, seeded random
              weights, synthetic-64 at batch 32, float32 with TF32 off;
              every kernel of the path must have launched;
  5. trace    torch.profiler over one batch: device time by kernel group;
  6. parity   the port on the card against the port on the CPU.
Then one JSON line of per-kernel numbers, and last the result line
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
ATOL_KERNEL = 1e-5         # float32 sums in another order than torch's reductions


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


def kernel_phase():
    """dsnt_jsd_fused against dsnt_jsd_plain at the flagship rows (B=1 and
    the main path's B=32) and the non-square 16x24 case."""
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_fused, dsnt_jsd_plain

    report = dict(name='dsnt_jsd_fwd', route='cuda', source='margipose_tpu_torch/csrc/dsnt_jsd.cu',
                  replaces='margipose_tpu/ops/pallas_dsnt.py:62', library_ms=None)
    worst = 0.0
    for b, j, h, w, sigma in [(1, 17, 32, 32, 1.0), (32, 17, 32, 32, 1.0), (1, 13, 16, 24, 2.0)]:
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
        bytes_moved = 4 * (rows * s + rows * 2 + rows * 4)  # p, mu read; out written
        ops = rows * s * 16  # per element: grid, q, m, 3 logs, 4 FMAs into the sums
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = 'bytes' if bytes_moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else 'operations'
        ms = median_ms(lambda: dsnt_jsd_fused(p, mu, sigma))
        dev_ms = graph_ms(lambda: dsnt_jsd_fused(p, mu, sigma))
        plain_ms = median_ms(lambda: dsnt_jsd_plain(p, mu, sigma))
        phase('kernels', f'dsnt_jsd {b}x{j}x{h}x{w} sigma={sigma}: max abs err {err:.3g} '
                         f'(atol {ATOL_KERNEL}); kernel {ms * 1e3:.2f} us per call eager, '
                         f'{dev_ms * 1e3:.2f} us in a CUDA graph; plain {plain_ms * 1e3:.2f} us; '
                         f'bound {bound_ms * 1e3:.3f} us ({bound_by}); library n/a')
        if (b, h, w) == (32, 32, 32):  # the main path's shape
            report.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    report['max_abs_err'] = worst
    return [report]


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
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_fused

    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, 'margipose-flagship-random.pth')
    save_model(ckpt, model, Default_MargiPose_Desc)
    counters = {'dsnt_jsd_fwd': dsnt_jsd_fused}
    for fn in counters.values():
        fn.launches = 0
    rows, stats = eval_3d.main(['--model', ckpt, '--dataset', 'synthetic-64',
                                '--batch-size', '32', '--device', 'cuda'])
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = 12 * stats['batches']  # 3 planes x 4 stages per batch
    phase('main', f"kernel launches {launches}, expected dsnt_jsd_fwd = 12 x "
                  f"{stats['batches']} batches = {expected}")
    if launches['dsnt_jsd_fwd'] != expected or expected == 0:
        raise AssertionError(f'main path launched dsnt_jsd_fwd {launches} times, expected {expected}')
    ms = [s * 1e3 for s in stats['batch_seconds']]
    phase('main', f'device ms per batch of 32: {", ".join(f"{m:.3f}" for m in ms)}; '
                  f'{32 * len(ms) / (sum(ms) / 1e3):.1f} images/s; '
                  f'mean loss {stats["mean_loss"]}')
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == 64):
        raise AssertionError('main path gave non-finite metrics or loss, or lost examples')
    phase('main', f'loss and coordinates finite; overall {eval_3d.overall_metrics(rows)}')
    return launches, ms


def trace_phase(model):
    """Where one batch of 32 spends its device time: torch.profiler over one
    forward + masked loss, kernels grouped by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from margipose_tpu_torch.models.margipose import margipose_masked_loss

    g = torch.Generator().manual_seed(2)
    x = torch.randn(32, 3, 256, 256, generator=g).cuda()
    target = (torch.rand(32, 17, 3, generator=g) * 1.6 - 0.8).cuda()
    mask = torch.ones(32, 17, device='cuda')
    valid_depth = torch.ones(32, dtype=torch.long, device='cuda')

    def step():
        with torch.inference_mode():
            margipose_masked_loss(model(x)[1], target, mask, valid_depth)

    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        phase('trace', f'window {window_ms:.3f} ms; kernel times not measured '
                       '(the profiler reported no device events)')
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def share(words):
        ms = sum(e.self_device_time_total for e in events
                 if any(w in e.key.lower() for w in words)) / 1e3
        return f'{ms:.3f} ms ({ms / busy_ms:.1%})'

    phase('trace', f'one batch of 32, forward + loss: window {window_ms:.3f} ms (CUDA events), '
                   f'kernels busy {busy_ms:.3f} ms, idle share {max(0.0, 1 - busy_ms / window_ms):.1%}; '
                   f'{len(events)} kernel names, {sum(e.count for e in events)} launches')
    # cuDNN's convolution kernels: implicit GEMM, FFT (r2c, pointwise complex
    # product, c2r) and dgrad (transposed convolution)
    conv_words = ('conv', 'gemm', 'xmma', 'fft', 'complex', 'dgrad')
    phase('trace', f'convolutions {share(conv_words)}; '
                   f'batch norm {share(("batch_norm", "bn_"))}; '
                   f'dsnt_jsd head {share(("dsnt_jsd",))}; softmax {share(("softmax",))}')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        phase('trace', f'  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:110]}')


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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card',
              file=sys.stderr)
        return 1
    kind, _ = device_phase()
    build_phase()
    kernels = kernel_phase()
    torch.cuda.synchronize()
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode

    set_float32_parity_mode()
    model = flagship('cuda')
    launches, _ = main_path_phase(model)
    for k in kernels:
        k['launches'] = launches[k['name']]
    trace_phase(model)
    parity_phase(model)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
