"""Benchmark: the flagship's throughput on one NVIDIA card.

    python -m margipose_tpu_torch.bench [--device cuda]

Counterpart of the repository's ``bench.py`` (``:206-437``), which stays the
JAX package's bench; its ``bench_baseline.json`` holds TPU numbers, which
this bench never reads. Prints ONE JSON line on stdout, with every key of
``bench.py``'s line under the same names and a few more (``LINE_KEYS``);
every diagnostic goes to stderr.

The model is MargiPose v6.0.1 at full width (4 stages, InceptionV4 stem,
256 px, 17 joints), weights from a seed and batch-norm statistics from one
train-mode pass, perturbed (``seeded_model``). The segments are those of
``bench.py``'s accelerator branch:

* inference at float32, TF32 off (``bin/eval_3d.set_float32_parity_mode``),
  at the base batch;
* inference at bf16 autocast, the headline: a sweep of batches, the best one
  measured again and the better reading kept;
* batch-1 latency at bf16: the median of single forwards, each timed on its
  own between two synchronisations: what one caller waits for a call (the
  reference's median per-batch time, reference:
  src/margipose/bin/eval_3d.py:60-62), not a floor drained from a queue;
* train steps at bf16 and float32 through ``train/steps.make_train_step``
  and ``train/schedules.make_optimiser('1cycle', lr=1.0, max_iters=1000)``:
  two warm-up steps, then the timed ones;
* the serving ceiling: ``bin/serve.py``'s ``Microbatcher`` around the
  forward ``make_runner`` builds (``model_runner``), fed decoded uint8
  frames faster than it drains (the best of three drains), and the same
  batcher around a stub runner for its own overhead.

Timing: CUDA events on the current stream around N enqueued calls, then
``torch.cuda.synchronize()``; the first call of each shape (cuDNN's plans
or its timed search) is timed apart and logged. Inference runs under the
eval bin's cuDNN policy (deterministic algorithms), training under the
train bin's (timed search), serving under the server's (heuristics). Peak
memory is ``torch.cuda.max_memory_allocated()`` a segment, after
``reset_peak_memory_stats()``; the line carries the largest. A segment that
fails fails the bench: nothing is caught and reported as null.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one batch-1 forward
of a ``meta``-device model (no arithmetic is done). ``mfu`` divides the
headline's rate by the H100 SXM's published dense peak at its precision
(989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores);
``train_mfu`` takes 3x the forward's FLOPs a trained image, as ``bench.py``.

``vs_baseline``: ``bench_reference.py`` (the reference architecture in eager
torch, ``tests/torch_twin.py``) runs in a child process from the root of the
checkout, at the same batch, on the same card, with TF32 off, so that both
sides compute in float32: the port's float32 inference images/s over the
reference's. The child's failure fails the bench. (``REFERENCE_CODE``: the
one change the child makes to the twin is where its DSNT grid is made.)

On the CPU (``device='cpu'``, as the tests run it) the bench runs the same
segments; the numbers that only a card has (``mfu``, ``train_mfu``,
``peak_memory_gib``, ``power_limit_w``) are null there.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import subprocess
import sys
import time
from os import path

import numpy as np
import torch

from margipose_tpu_torch import resolve_device

ROOT = path.dirname(path.dirname(path.abspath(__file__)))
METRIC = 'margipose_infer_images_per_sec_per_chip_256px'
HEADLINE = 'bfloat16'
# NVIDIA's data sheet, H100 SXM, dense: the tensor cores' bf16 rate, and
# float32 outside them (TF32 is off in the float32 segments)
PEAK_FLOPS = {'H100': {'bfloat16': 989e12, 'float32': 67e12}}
# timed calls a segment, as bench.py: inference at the headline batch and at
# float32, each further batch of the sweep, batch-1 samples, train steps,
# serving drains (batches) with the real runner and with the stub
FULL_ITERS = {'infer': 50, 'sweep': 30, 'b1': 20, 'train': 10, 'serve': 10, 'stub': 20}
SERVE_REPS = 3  # the best of this many drains
# The child that runs the reference: TF32 off, then the unedited script,
# from the root of the checkout. Two things are set up first. ``tests`` is
# the checkout's directory: a ``tests`` package installed elsewhere would
# otherwise shadow it, since tests/ has no __init__.py. And on the card the
# twin's DSNT grid is made there: tests/torch_twin.py builds it with
# torch.arange on the CPU, which a heatmap on the card cannot multiply (the
# reference's dsntnn builds it on the heatmap's device; the values are the
# same).
REFERENCE_CODE = """
import os, runpy, sys, types
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
tests = types.ModuleType('tests')
tests.__path__ = [os.path.abspath('tests')]
sys.modules['tests'] = tests
if torch.cuda.is_available():
    import tests.torch_twin as twin

    def linspace(length, dtype=torch.float32):
        first = -(length - 1.0) / length
        return torch.arange(length, dtype=dtype, device='cuda') * (2.0 / length) + first

    twin.t_normalized_linspace = linspace
runpy.run_path('bench_reference.py', run_name='__main__')
"""
LINE_KEYS = (
    'metric', 'value', 'unit', 'vs_baseline', 'precision', 'batch', 'mfu',
    'train_images_per_sec', 'train_mfu', 'infer_latency_ms_b1', 'serve_images_per_sec',
    'serve_batch_occupancy', 'serve_batcher_overhead_frac', 'serve_device_forward_frac',
    'serve_upload_mb_per_sec', 'serve_link_bound',
    'infer_images_per_sec_float32', 'train_images_per_sec_float32', 'flops_per_image',
    'peak_memory_gib', 'device_name', 'power_limit_w', 'torch_version',
    'reference_infer_images_per_sec', 'reference_train_images_per_sec')


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@torch.no_grad()
def calibrate_bn(model, images, generator):
    """BN running stats from one train-mode pass over ``images``, perturbed
    at random."""
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


@torch.no_grad()
def randomize_batch_norm(model, images, generator):
    """BN running stats from one train-mode pass over ``images``, perturbed
    at random; the last residual block of every column scaled down, so the
    heatmaps are neither flat nor one-hot (as with trained weights)."""
    calibrate_bn(model, images, generator)
    for plane in ('xy', 'zy', 'xz'):
        for column in getattr(model.inner, f'{plane}_hm_cnns'):
            last = column.up_layers[4]
            for bn in (last.module[4], last.shortcut[1]):
                bn.weight *= 0.5
                bn.bias *= 0.5


def seeded_model(desc, device, seed=0):
    """MargiPose ``desc`` on ``device``, its weights from ``seed`` and its
    batch-norm statistics from ``randomize_batch_norm`` on 8 seeded images."""
    from margipose_tpu_torch.models import create_model

    g = torch.Generator().manual_seed(seed)
    model = create_model(desc, generator=g).to(device)
    size = _size(desc)
    randomize_batch_norm(model, torch.randn(8, 3, size, size, generator=g).to(device), g)
    return model


def flops_per_image(desc) -> float:
    """FLOPs of one batch-1 forward of ``desc``'s model, as torch's FLOP
    counter counts them, on a ``meta`` model (shapes only)."""
    from torch.utils.flop_counter import FlopCounterMode

    from margipose_tpu_torch.models import create_model

    size = _size(desc)
    with torch.device('meta'):
        model = create_model(desc).eval()
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.empty(1, 3, size, size))
    return float(counter.get_total_flops())


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def call_seconds(fn, device) -> float:
    """Seconds of one call between two synchronisations (host clock)."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def seconds_per_call(fn, n, device, warmup=3) -> float:
    """Seconds a call of ``n`` calls enqueued back to back after ``warmup``:
    CUDA events on the current stream around them, then a synchronize (on
    the CPU, the host clock)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / n


def _launches():
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_bwd, dsnt_jsd_fwd

    return {'dsnt_jsd_fwd': dsnt_jsd_fwd.launches, 'dsnt_jsd_bwd': dsnt_jsd_bwd.launches}


@contextlib.contextmanager
def segment(records, name, device):
    """Records a segment's calls (the caller counts them into the yielded
    dict), its loss-head kernels' host launches (a train step replayed from
    its CUDA graph launches none: the train segments add ``step_counts``)
    and its peak device memory."""
    before = _launches()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    record = records[name] = {'calls': 0}
    yield record
    _sync(device)
    record['launches'] = {k: v - before[k] for k, v in _launches().items()}
    record['peak_memory_gib'] = (torch.cuda.max_memory_allocated(device) / 2**30
                                 if device.type == 'cuda' else None)
    peak = record['peak_memory_gib']
    counts = ''.join(f', {k} {v}' for k, v in record.get('step_counts', {}).items())
    log(f"segment {name}: {record['calls']} calls, loss-head host launches "
        f"{record['launches']}{counts}, "
        f"peak memory {'not measured (CPU)' if peak is None else f'{peak:.3f} GiB'}")


def _counted(fn, record):
    def call(*args):
        record['calls'] += 1
        return fn(*args)
    return call


def _images(batch, size, device, seed=0):
    x = np.random.RandomState(seed).randn(batch, 3, size, size).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _use_policy(name):
    """cuDNN's algorithm choice as the bin named sets it."""
    from margipose_tpu_torch.utils import init_algorithms

    if name == 'eval':
        init_algorithms(deterministic=True)
        log('cuDNN policy: the eval bin\'s (deterministic algorithms, no timed search)')
    elif name == 'train':
        init_algorithms(deterministic=False)
        log('cuDNN policy: the train bin\'s (cudnn.benchmark: a timed search a shape)')
    else:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False
        log('cuDNN policy: the server\'s (heuristics, no timed search)')


def inference(model, size, batches, precision, iters, device, records, name):
    """The best images/s over ``batches`` of ``size`` px images at
    ``precision`` (make_forward_fn), its batch, and ms a call by batch."""
    from margipose_tpu_torch.train.steps import make_forward_fn

    ms = {}
    with segment(records, name, device) as record:
        forward = _counted(make_forward_fn(model, compute_dtype=precision), record)
        for i, b in enumerate(batches):
            images = _images(b, size, device)
            first = call_seconds(lambda: forward(images), device)
            t = seconds_per_call(lambda: forward(images), iters['infer' if i == 0 else 'sweep'],
                                 device)
            ms[b] = t * 1e3
            log(f'inference[{precision}]: batch {b}, first call {first * 1e3:.1f} ms, then '
                f'{t * 1e3:.3f} ms/step, {b / t:.2f} images/sec')
        best = max(ms, key=lambda b: b / ms[b])
        ips = best * 1e3 / ms[best]
        if len(batches) > 1:
            # the better of two readings of the winning batch, as bench.py
            images = _images(best, size, device)
            t = seconds_per_call(lambda: forward(images), iters['infer'], device)
            log(f'inference[{precision}]: batch {best} re-measured, {best / t:.2f} images/sec')
            ips = max(ips, best / t)
    return ips, best, ms


def latency_b1(model, size, precision, n, device, records):
    """Median ms of ``n`` batch-1 forwards, each between two synchronisations."""
    from margipose_tpu_torch.train.steps import make_forward_fn

    with segment(records, 'infer_b1', device) as record:
        forward = _counted(make_forward_fn(model, compute_dtype=precision), record)
        image = _images(1, size, device)
        first = call_seconds(lambda: forward(image), device)
        samples = sorted(call_seconds(lambda: forward(image), device) * 1e3
                         for _ in range(n))
    median = samples[len(samples) // 2]
    log(f'batch-1 latency [{precision}]: median {median:.3f} ms of {n} calls, each timed '
        f'alone between two synchronisations (a caller\'s wait, not a queue-drained floor); '
        f'first call {first * 1e3:.1f} ms; samples {", ".join(f"{s:.2f}" for s in samples)}')
    return median


def train_batch(batch, size, n_joints, device):
    """``bench.py``'s train batch from RandomState(1), images NCHW."""
    rnd = np.random.RandomState(1)
    images = rnd.randn(batch, size, size, 3).astype(np.float32)
    target = rnd.uniform(-0.9, 0.9, (batch, n_joints, 3)).astype(np.float32)
    return {'input': torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(device),
            'target': torch.from_numpy(target).to(device),
            'joint_mask': torch.ones(batch, n_joints, device=device),
            'valid_depth': torch.ones(batch, dtype=torch.int32, device=device)}


def train(model, desc, size, batch, precision, iters, device, records):
    """Images/s of train steps of ``batch`` at ``precision``, on a copy of
    ``model`` (the inference segments' model stays as it is)."""
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step, step_counts

    with segment(records, f'train_{precision}', device) as record:
        copy_ = copy.deepcopy(model)
        state = TrainState(copy_, make_optimiser('1cycle', copy_.parameters(), 1.0,
                                                 max_iters=1000))
        train_step = make_train_step(desc['settings'].get('pixelwise_loss', 'jsd'),
                                     compute_dtype=precision)
        step = _counted(train_step, record)
        data = train_batch(batch, size, _n_joints(desc), device)
        last = {}

        def run_step():
            last.update(step(state, data))

        first = call_seconds(run_step, device)
        t = seconds_per_call(run_step, iters, device, warmup=1)
        loss = float(last['loss'])
        record['step_counts'] = step_counts(train_step)
        del state, copy_, last
    if not math.isfinite(loss):
        raise RuntimeError(f'train[{precision}]: loss {loss} after {record["calls"]} steps')
    log(f'train[{precision}]: batch {batch}, first step {first * 1e3:.1f} ms (cuDNN\'s '
        f'search), then {t * 1e3:.3f} ms/step, {batch / t:.2f} images/sec; loss {loss:.4f}')
    return batch / t


def serving(model, desc, batch, precision, forward_ms, iters, device, records):
    """The Microbatcher's ceiling (``bench.py``'s ``_bench_serving``): decoded
    uint8 frames queued faster than it drains, the best of SERVE_REPS
    drains; then the batcher around a stub runner, for its own overhead."""
    from margipose_tpu_torch.bin.serve import Microbatcher, model_runner
    from margipose_tpu_torch.models import data_specs_for_desc

    size = _size(desc)
    with segment(records, 'serve', device) as record:
        runner = _counted(model_runner(model, data_specs_for_desc(desc).input_specs, precision,
                                       device), record)
        u8 = (np.random.RandomState(2).rand(batch, size, size, 3) * 255).astype(np.uint8)
        first = call_seconds(lambda: runner(u8), device)
        log(f'serve forward[{precision}]: first call {first * 1e3:.1f} ms')
        frames = [np.ascontiguousarray(u8[i]) for i in range(batch)]

        def measure(r, n_timed):
            """Saturation drain: submit n_timed batches' frames and wait for
            the last; the dispatcher is FIFO, so every batch is done."""
            occupancies = []
            mb = Microbatcher(r, batch_size=batch, max_wait_s=0.008,
                              on_batch=occupancies.append)

            def drain(n_batches):
                t0 = time.perf_counter()  # before the puts: dispatch starts during them
                items = [mb.submit(frames[i % batch]) for i in range(n_batches * batch)]
                if not items[-1].event.wait(300):
                    raise RuntimeError('microbatcher drain timed out')
                failed = [it.error for it in items if it.error is not None]
                if failed:
                    raise RuntimeError(f'{len(failed)} served requests failed') from failed[0]
                return time.perf_counter() - t0

            drain(3)  # warm: steady-state queues, allocator, result paths
            occ0 = len(occupancies)
            best = min(drain(n_timed) for _ in range(SERVE_REPS))
            window = occupancies[occ0:]
            return n_timed * batch / best, sum(window) / len(window)

        serve_ips, occupancy = measure(runner, iters['serve'])
    log(f'serve microbatcher ceiling [{precision}]: batch {batch}, {serve_ips:.2f} images/sec, '
        f'mean occupancy {occupancy:.2f}')
    stub_out = np.zeros((batch, _n_joints(desc), 3), np.float32)
    stub_ips, _ = measure(lambda _u8: stub_out, iters['stub'])
    overhead_ms = 1e3 * batch / stub_ips
    real_ms = 1e3 * batch / serve_ips
    upload = serve_ips * size * size * 3 / 1e6  # uint8 frames
    log(f'serve batcher stub overhead: {overhead_ms:.3f} ms/batch '
        f'({overhead_ms / real_ms:.1%} of the {real_ms:.3f} ms real batch); device forward '
        f'{forward_ms:.3f} ms ({forward_ms / real_ms:.1%}); input upload {upload:.1f} MB/s')
    return {'ips': serve_ips, 'occupancy': occupancy,
            'batcher_overhead_frac': overhead_ms / real_ms,
            'device_forward_frac': forward_ms / real_ms,
            'upload_mb_per_sec': upload,
            # neither the batcher (< 20%) nor the device forward (< 50%)
            # explains the batch's time: the host-device round trip does
            'link_bound': overhead_ms / real_ms < 0.2 and forward_ms / real_ms < 0.5}


def run_reference(batch, device):
    """``bench_reference.py`` in a child process from the root of the
    checkout, TF32 off: its JSON line. Raises if it fails, or ran on
    another kind of device than ``device``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', REFERENCE_CODE, str(batch)], cwd=ROOT,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f'bench_reference.py exited {proc.returncode}: {proc.stderr[-3000:]}')
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if torch.device(result['device']).type != device.type:
        raise RuntimeError(f"bench_reference.py ran on {result['device']}, not {device}")
    log(f'reference (bench_reference.py, TF32 off, {time.perf_counter() - t0:.1f} s): '
        f'{json.dumps(result)}')
    return result


def card_identity(device):
    """(name, power limit in W or None, the nvidia-smi line or None)."""
    if device.type != 'cuda':
        return 'cpu', None, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(['nvidia-smi', '-i', str(index), '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return torch.cuda.get_device_name(index), float(smi.rsplit(',', 1)[1].split()[0]), smi


def _peak(name, precision):
    return next((v[precision] for k, v in PEAK_FLOPS.items() if k in name), None)


def _size(desc):
    return desc['settings'].get('input_size', 256)


def _n_joints(desc):
    from margipose_tpu_torch.models import data_specs_for_desc

    return data_specs_for_desc(desc).output_specs.skeleton_desc.n_joints


def _round(x, n):
    return None if x is None else round(x, n)


def run_bench(device='cuda', desc=None, batch=32, sweep=None, iters=None,
              reference=run_reference):
    """Run every segment and print the line; returns (line, records), the
    records a segment's calls, loss-head launches and peak memory.

    ``sweep``: the bf16 batches, ``batch`` among them (default batch, 2x,
    4x); ``iters``: the timed calls of every segment (default
    ``FULL_ITERS``, bench.py's counts); ``reference(batch, device)`` gives
    the reference's line (default: ``bench_reference.py`` in a child)."""
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
    from margipose_tpu_torch.models import Default_MargiPose_Desc

    device = resolve_device(device)
    desc = desc or Default_MargiPose_Desc
    sweep = tuple(sweep or (batch, 2 * batch, 4 * batch))
    if batch not in sweep:
        raise ValueError(f'the sweep {sweep} must hold the base batch {batch}')
    iters = FULL_ITERS if iters is None else dict.fromkeys(FULL_ITERS, int(iters))
    name, power_w, smi = card_identity(device)
    log(f'device: {device} ({name}); torch {torch.__version__}, CUDA {torch.version.cuda}'
        + (f'; {smi}' if smi else ''))
    flops = flops_per_image(desc)
    log(f'flops/image (torch.utils.flop_counter, batch-1 forward): {flops:.4e}')

    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    records = {}
    try:
        set_float32_parity_mode()
        log('float32 segments: TF32 off for convolutions and matmuls')
        t0 = time.perf_counter()
        model = seeded_model(desc, device)
        log(f'model: {desc["type"]} {desc["version"]} {desc["settings"]}, seed 0, '
            f'{sum(p.numel() for p in model.parameters())} parameters '
            f'({time.perf_counter() - t0:.1f} s)')

        _use_policy('eval')
        size = _size(desc)
        f32_ips, _, _ = inference(model, size, (batch,), 'float32', iters, device, records,
                                  'infer_float32')
        # the base batch first, as bench.py; the rest of the sweep after it
        order = (batch,) + tuple(b for b in sweep if b != batch)
        ips, best, ms = inference(model, size, order, HEADLINE, iters, device, records,
                                  f'infer_{HEADLINE}')
        b1_ms = latency_b1(model, size, HEADLINE, iters['b1'], device, records)

        _use_policy('train')
        train_ips = {p: train(model, desc, size, batch, p, iters['train'], device, records)
                     for p in (HEADLINE, 'float32')}

        _use_policy('serve')
        serve = serving(model, desc, batch, HEADLINE, ms[batch], iters, device, records)
        del model
        if device.type == 'cuda':
            torch.cuda.empty_cache()  # the card to the reference's process
        ref = reference(batch, device)
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags

    peak = _peak(name, HEADLINE)
    mems = [r['peak_memory_gib'] for r in records.values() if r['peak_memory_gib'] is not None]
    line = {
        'metric': METRIC,
        'value': round(ips, 2),
        'unit': 'images/sec/chip',
        # like precision with like: the port's float32 against the reference's
        'vs_baseline': round(f32_ips / ref['infer_images_per_sec'], 4),
        'precision': HEADLINE,
        'batch': best,
        'mfu': _round(peak and flops * ips / peak, 4),
        'train_images_per_sec': round(train_ips[HEADLINE], 2),
        'train_mfu': _round(peak and 3 * flops * train_ips[HEADLINE] / peak, 4),
        'infer_latency_ms_b1': round(b1_ms, 3),
        'serve_images_per_sec': round(serve['ips'], 2),
        'serve_batch_occupancy': round(serve['occupancy'], 2),
        'serve_batcher_overhead_frac': round(serve['batcher_overhead_frac'], 4),
        'serve_device_forward_frac': round(serve['device_forward_frac'], 4),
        'serve_upload_mb_per_sec': round(serve['upload_mb_per_sec'], 1),
        'serve_link_bound': serve['link_bound'],
        'infer_images_per_sec_float32': round(f32_ips, 2),
        'train_images_per_sec_float32': round(train_ips['float32'], 2),
        'flops_per_image': flops,
        'peak_memory_gib': _round(max(mems) if mems else None, 3),
        'device_name': name,
        'power_limit_w': power_w,
        'torch_version': torch.__version__,
        'reference_infer_images_per_sec': ref['infer_images_per_sec'],
        'reference_train_images_per_sec': ref['train_images_per_sec'],
    }
    if smi:
        log(f'card: {smi}')
    print(json.dumps(line), flush=True)
    return line, records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda',
                        help='cuda (default; an error without a card) or cpu')
    args = parser.parse_args(argv)
    run_bench(args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
