#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (margipose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device        the card's name and power limit (nvidia-smi);
  2. build         every kernel in margipose_tpu_torch/csrc/, one nvcc per
                   source;
  3. kernels       the kernels' branch-free log against logf over every
                   normal float; each grouped kernel against its plain
                   PyTorch version on the card, at the shape the main paths
                   give it (12 groups of 32x17x32x32), one group, and the
                   generic layout (16x24, H*W % 4 != 0, unaligned pointers),
                   with times and bounds; the head's autograd through the
                   CUDA backward against autograd through the plain version;
                   and (printed under [datasets]) both kernels at the main
                   shape on the mixed 2D/3D recipe's rows: target means in
                   [-3, 3], a third of the zy/xz rows with a zero upstream
                   gradient;
     sweep         both kernels at 13, 544 and 6,528 rows of 32x32: a
                   launch's fixed cost against its cost per row;
  4. main          the flagship eval path through its entry point
                   (margipose_tpu_torch.bin.eval_3d.main): MargiPose v6.0.1,
                   InceptionV4, 4 stages, 256 px, 17 joints, seeded random
                   weights, synthetic-64 at batch 32, float32 with TF32 off;
                   the forward kernel must have launched once a batch;
  5. trace         torch.profiler over one eval batch: device time by kernel
                   group;
  6. parity        the eval forward on the card against the CPU;
  7. train         the flagship train path through its entry point
                   (margipose_tpu_torch.bin.train_3d.main): synthetic data at
                   batch 32, a few 1cycle steps and one validation batch, a
                   model-latest checkpoint, which bin.eval_3d then reads;
                   both kernels must have launched once a step (and the
                   forward once a validation batch);
  8. train trace   torch.profiler over one train step at batch 32;
  9. train parity  one train step at batch 2 on the card against the CPU,
                   and two steps on the card with a planted fault (one
                   example's loss dropped, one batch norm's gradients
                   zeroed) that its rule must reject; a third fault, one
                   joint of one example dropped, read against that rule and
                   a joint-row rule on the last convolutions, one of which
                   must reject it;
 10. bf16 eval     bin.eval_3d at batch 32 with --precision bfloat16 --ship
                   uint8 (the forward kernel once a batch), bf16 against
                   float32 coordinates on one batch, and a profiled bf16
                   batch by kernel group (are cuDNN's FFT convolutions gone?);
 11. multicrop     bin.eval_3d --multicrop: 10 crops an example, the forward
                   kernel once an example;
 12. bf16 train    bin.train_3d with precision='bfloat16', ship='uint8':
                   both kernels once a step, float32 weights, BN statistics
                   and optimiser state; a profiled bf16 train step;
 13. infer         bin.infer_single.infer_image on resources/man_running.jpg,
                   one crop and ten, card against CPU (float32);
 14. serve         bin.serve.create_server on the flagship at batch 8 in bf16:
                   16 concurrent /predict requests, /healthz, /info,
                   /metrics, then 4 requests one at a time; served
                   coordinates against a direct runner call (timed); one
                   float32 request against the CPU;
 15. host ops      the port's host-ops library (csrc/host_ops.cpp, built by
                   g++ in phase 2) against the port's PIL path on
                   resources/man_running.jpg: the warp and the fused warp +
                   colour jitter, within the uint8 LSBs the JAX package's
                   note allows, timed per example;
 16. stems         MargiPose with each ResNet stem (resnet18/34/50), 4
                   stages, 256 px: the forward card against CPU at batch 2,
                   a batch of 32 timed; resnet34 traced (eval and train, float32
                   and bf16); then bin.train_3d with the resnet34 stem grafted
                   from a torchvision-format backbone the script writes from
                   seeded tensors (pretrained_stem), 2 steps at batch 32 and a
                   validation batch: both kernels once a step;
 17. chatterbox    Chatterbox v1.3.0 (Default_Chatterbox_Desc) at full width,
                   seeded random weights, calibrated BN: bin.eval_3d on
                   synthetic-64 at batch 32 in float32 and in bf16 with uint8
                   upload (the forward kernel once a batch, 3 groups), traces;
                   card against CPU at batch 2; bin.train_3d with the
                   chatterbox_model preset, 3 steps at batch 32 and a
                   validation batch (both kernels once a step); traced train
                   steps in float32 and bf16; one train step at batch 2 card
                   against CPU, and its planted faults; bin.infer_single.infer_image card against CPU;
 18. datasets      one flagship train step at batch 2 on a mixed 2D/3D batch
                   (a 2D example with half its joints masked and targets off
                   the map), card against CPU; before phase 4 (printed as
                   [cudnn policy]), a forward + loss at batch 32 under each
                   cuDNN policy in turn (heuristics; deterministic, as eval
                   and infer set it; timed search; heuristics after the
                   search). Where h5py is
                   installed, on fake corpora under build/chip_smoke/:
                   bin.eval_3d with no --dataset (mpi3d-test, 48 frames of
                   768 px, batch 32, float32), its tables, device ms and the
                   host's share of the window; --multicrop on 4 examples;
                   h36m-test at batch 8; bin.train_3d with the mpi3d preset
                   (mpi3d-trainval + mpii-trainval, augmented, 3 steps of
                   32). Without h5py one line says these did not run.
The float32 phases (4-9 and the float32 parts of 16-17) pass precision
float32 and float32 input upload explicitly. Each path's kernel launches are
counted from 0 around it. Then one JSON line of per-kernel numbers, and last
the result line {"ok": true, "device": {...}}. Without a CUDA device it
exits 1 and prints no result. The flagship's train paths run 4 steps; the
later paths run 2-3 to keep the script near 5 minutes.
"""

from __future__ import annotations

import concurrent.futures
import copy
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
ATOL_KERNEL = 1e-5         # float32 sums in another order than torch's reductions
# dp is O(1) (grid coordinates and log ratios); the kernel's logs and
# contracted multiply-adds round apart from torch's by a few ulp
ATOL_GRAD = 1e-5
KERNEL_SHAPES = [  # (G groups, B, J, H, W, sigma, pointer offset in floats)
    (12, 32, 17, 32, 32, 1.0, 0),  # the main paths': 4 stages x 3 planes at batch 32
    (12, 10, 17, 32, 32, 1.0, 0),  # the multicrop eval's: one example's 10 crops
    (3, 32, 17, 32, 32, 1.0, 0),   # Chatterbox's: 1 stage x 3 planes at batch 32
    (1, 1, 17, 32, 32, 1.0, 0),    # one group (dsnt_jsd_fused), B = 1
    (3, 1, 13, 16, 24, 2.0, 0),    # the generic layout: non-square, sigma 2
    (2, 1, 13, 7, 9, 1.5, 0),      # the generic layout: H*W % 4 != 0
    (2, 2, 17, 32, 32, 1.0, 1),    # the generic layout: 32x32 off 16-byte alignment
]
# the mixed 2D/3D recipe's rows at the main paths' shape: target means off the
# map (MPII joints that leave the crop, rotation and shifts), and zero
# upstream gradients in the zy/xz groups for the 2D examples
MIXED_RECIPE_SHAPE = (12, 32, 17, 32, 32, 1.0, 0)
MIXED_RECIPE_SPREAD = 3.0
DROPPED_JOINT = 7          # the joint a planted train fault drops from one example
MAIN_SHAPE = (12, 32, 32, 32, 0)  # the main paths' (G, B, H, W, offset): 17 joints
CHATTERBOX_SHAPE = (3, 32, 32, 32, 0)
SWEEP_ROWS = [(1, 1, 13), (1, 32, 17), (12, 32, 17)]  # (G, B, J): 13, 544, 6528 rows
PALLAS = 'margipose_tpu/ops/pallas_dsnt.py'
TRAIN_STEPS = 4            # the train path's steps at batch 32
MULTICROP_EXAMPLES = 4     # the multicrop eval's examples, 10 crops each
STEMS = ('resnet18', 'resnet34', 'resnet50')
STEM_TRAIN_STEPS = 2       # the resnet34 stem's train path at batch 32
CHATTERBOX_STEPS = 3       # the Chatterbox train path at batch 32
MPI3D_TRAIN_STEPS = 3      # the mpi3d preset's train path at batch 32
# Chatterbox's heads' last 1x1 convolutions scaled: soft heatmaps from random
# weights (mean peaks about 0.15-0.25)
CHATTERBOX_HEAD_SCALES = {'xy_hm_cnn': 0.3, 'zy_hm_cnn': 0.6, 'xz_hm_cnn': 0.6}
SERVE_REQUESTS = 16        # concurrent /predict requests to the bf16 server
SERVE_ALONE = 4            # then requests one at a time
IMAGE = os.path.join(ROOT, 'resources', 'man_running.jpg')


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

    names = _build.kernel_sources() + ['host_ops']
    t0 = time.perf_counter()
    _build.build(names)
    phase('build', f'{names} built in {time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}')


def dsnt_jsd_inputs(g, b, j, h, w, offset, seed, spread=0.8):
    """G heatmap groups on the card, each ``offset`` floats into its storage,
    and their targets in [-spread, spread], repeating over three planes as
    the model's stages share them."""
    from margipose_tpu_torch.ops.dsnt import flat_softmax

    gen = torch.Generator().manual_seed(seed)
    hms = []
    for _ in range(g):
        p = flat_softmax(torch.randn(b, j, h, w, generator=gen) * 2)
        flat = torch.zeros(p.numel() + offset, device='cuda')
        flat[offset:] = p.reshape(-1).cuda()
        hms.append(flat[offset:].view(b, j, h, w))
    planes = [((torch.rand(b, j, 2, generator=gen) * 2 - 1) * spread).cuda() for _ in range(3)]
    return hms, [planes[i % 3] for i in range(g)]


def mixed_recipe_grad(g, b, j, generator):
    """An upstream gradient [G, B*J, 4] as the mixed 2D/3D recipe gives it:
    in the zy/xz groups (i % 3 != 0) the rows of every third example (an
    MPII example, whose zy/xz losses are dropped) are exactly zero. Returns
    (grad, the rows that are zero in those groups)."""
    grad = torch.randn(g, b * j, 4, generator=generator)
    two_d = (torch.arange(b * j) // j) % 3 == 1
    for i in range(g):
        if i % 3:
            grad[i, two_d] = 0
    return grad.cuda(), two_d.cuda()


def bound(bytes_moved, ops):
    """(least ms the card could take, what bounds it): each input read once,
    each output written once, at the HBM rate; the operations at the float32
    rate outside the tensor cores."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def fwd_bound(g, rows, s):
    # p, mu read; out written. Per element: grid, q, m, 2 logs, 4 FMAs
    return bound(4 * g * (rows * s + rows * 2 + rows * 4), g * rows * s * 16)


def bwd_bound(g, rows, s):
    # p, mu, grad read; dp written. Per element: grid, q, m, 2 logs, 3 FMAs
    return bound(4 * g * (2 * rows * s + rows * 2 + rows * 4), g * rows * s * 16)


def shape_name(g, b, j, h, w, sigma, offset):
    return (f'{g}x{b}x{j}x{h}x{w} sigma={sigma}'
            + (f', pointers {4 * offset} B off 16-byte alignment' if offset else ''))


def kernel_phase():
    """The grouped forward kernel against its plain version at every shape
    of KERNEL_SHAPES: the main paths' 12 groups at batch 32 and at the
    multicrop eval's 10 crops, one group, the generic layout, H*W % 4 != 0
    and unaligned pointers. Eager time is through
    dsnt_jsd_grouped (what the model calls: the autograd Function and the
    views); the graph time is the kernel's wrapper alone."""
    from margipose_tpu_torch.ops.dsnt_jsd import (
        dsnt_jsd_fwd,
        dsnt_jsd_fwd_plain,
        dsnt_jsd_grouped,
        log_normal_mismatches,
    )

    mismatches = log_normal_mismatches()
    phase('kernels', f'log_normal against logf over every normal positive float: {mismatches} '
                     f'values differ')
    if mismatches:
        raise AssertionError('the kernels\' log_normal is not logf on its domain')
    hms, mus = dsnt_jsd_inputs(1, 2, 17, 32, 32, 0, seed=9)
    try:
        dsnt_jsd_grouped([hms[0].bfloat16()], mus, 1.0)
    except TypeError as exc:
        phase('kernels', f'a bf16 heatmap reaching dsnt_jsd_grouped raises: {exc}')
    else:
        raise AssertionError('dsnt_jsd_grouped took a bf16 heatmap')
    report = dict(name='dsnt_jsd_fwd', route='cuda', source='margipose_tpu_torch/csrc/dsnt_jsd.cu',
                  replaces=f'{PALLAS}:62', library_ms=None)
    worst = 0.0
    for g, b, j, h, w, sigma, offset in KERNEL_SHAPES:
        hms, mus = dsnt_jsd_inputs(g, b, j, h, w, offset, seed=g * 1000 + b * 100 + h)
        rows = dsnt_jsd_fwd(hms, mus, sigma)
        expected = dsnt_jsd_fwd_plain(hms, mus, sigma)
        heads = dsnt_jsd_grouped(hms, mus, sigma)
        torch.cuda.synchronize()
        err = (rows - expected).abs().max().item()
        for (coords, jsd), row in zip(heads, rows):  # the views the model reads
            if not (torch.equal(coords.reshape(-1, 2), row[:, :2])
                    and torch.equal(jsd.reshape(-1), row[:, 2])):
                raise AssertionError('dsnt_jsd_grouped views disagree with the kernel rows')
        if not err <= ATOL_KERNEL:
            raise AssertionError(f'dsnt_jsd_fwd disagrees with its plain version at '
                                 f'{shape_name(g, b, j, h, w, sigma, offset)}: max abs err '
                                 f'{err} > {ATOL_KERNEL}')
        worst = max(worst, err)
        bound_ms, bound_by = fwd_bound(g, b * j, h * w)
        ms = median_ms(lambda: dsnt_jsd_grouped(hms, mus, sigma))
        dev_ms = graph_ms(lambda: dsnt_jsd_fwd(hms, mus, sigma))
        plain_ms = median_ms(lambda: dsnt_jsd_fwd_plain(hms, mus, sigma))
        phase('kernels', f'dsnt_jsd_fwd {shape_name(g, b, j, h, w, sigma, offset)} ({g * b * j} '
                         f'rows): max abs err {err:.3g} (atol {ATOL_KERNEL}); kernel '
                         f'{ms * 1e3:.2f} us per call eager, {dev_ms * 1e3:.2f} us in a CUDA graph; '
                         f'plain {plain_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us '
                         f'({bound_by}); library n/a')
        if (g, b, h, w, offset) == MAIN_SHAPE:
            report.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        if (g, b, h, w, offset) == CHATTERBOX_SHAPE:
            report['chatterbox'] = dict(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    g, b, j, h, w, sigma, offset = MIXED_RECIPE_SHAPE
    hms, mus = dsnt_jsd_inputs(g, b, j, h, w, offset, seed=61, spread=MIXED_RECIPE_SPREAD)
    rows = dsnt_jsd_fwd(hms, mus, sigma)
    expected = dsnt_jsd_fwd_plain(hms, mus, sigma)
    torch.cuda.synchronize()
    err = (rows - expected).abs().max().item()
    finite = bool(torch.isfinite(rows).all())
    phase('datasets', f'dsnt_jsd_fwd on the mixed 2D/3D recipe\'s rows '
                      f'({shape_name(g, b, j, h, w, sigma, offset)}, target means in '
                      f'[-{MIXED_RECIPE_SPREAD}, {MIXED_RECIPE_SPREAD}]): max abs err {err:.3g} '
                      f'(atol {ATOL_KERNEL}), finite {finite}; kernel '
                      f'{graph_ms(lambda: dsnt_jsd_fwd(hms, mus, sigma)) * 1e3:.2f} us in a CUDA '
                      f'graph')
    if not (err <= ATOL_KERNEL and finite):
        raise AssertionError('dsnt_jsd_fwd disagrees with its plain version on off-map targets')
    report['mixed_rows_max_abs_err'] = err
    report['max_abs_err'] = max(worst, err)
    return report


def backward_kernel_phase():
    """The grouped backward kernel against its plain version at the
    forward's shapes, and the gradient of flat_softmax -> dsnt_jsd_grouped
    (one launch each way) against that of flat_softmax -> dsnt_jsd_plain per
    group (torch autograd), with no gradient reaching the targets."""
    from margipose_tpu_torch.ops.dsnt import flat_softmax
    from margipose_tpu_torch.ops.dsnt_jsd import (
        dsnt_jsd_bwd,
        dsnt_jsd_bwd_plain,
        dsnt_jsd_grouped,
        dsnt_jsd_plain,
    )

    def plain_grouped(hms, mus, sigma):
        return [dsnt_jsd_plain(hm, mu, sigma) for hm, mu in zip(hms, mus)]

    report = dict(name='dsnt_jsd_bwd', route='cuda', source='margipose_tpu_torch/csrc/dsnt_jsd.cu',
                  replaces=f'{PALLAS}:79', library_ms=None)
    worst = 0.0
    for g, b, j, h, w, sigma, offset in KERNEL_SHAPES:
        hms, mus = dsnt_jsd_inputs(g, b, j, h, w, offset, seed=g * 1000 + b * 100 + h + 1)
        gen = torch.Generator().manual_seed(g + b + h)
        grad = torch.randn(g, b * j, 4, generator=gen).cuda()
        dp = dsnt_jsd_bwd(hms, mus, grad, sigma)
        expected = dsnt_jsd_bwd_plain(hms, mus, grad, sigma)
        torch.cuda.synchronize()
        err = (dp - expected).abs().max().item()

        logits = [(torch.randn(b, j, h, w, generator=gen) * 2).cuda() for _ in range(g)]
        weights = [torch.randn(b, j, 3, generator=gen).cuda() for _ in range(g)]
        grads = []
        for head in (dsnt_jsd_grouped, plain_grouped):
            lgs = [lg.clone().requires_grad_() for lg in logits]
            targets = [mu.clone().requires_grad_() for mu in mus]
            heads = head([flat_softmax(lg) for lg in lgs], targets, sigma)
            loss = sum((c * wt[..., :2]).sum() + (d * wt[..., 2]).sum()
                       for (c, d), wt in zip(heads, weights))
            grads.append(torch.autograd.grad(loss, lgs + targets, allow_unused=True))
        (kernel_grads, plain_grads) = grads
        autograd_err = max((a - c).abs().max().item()
                           for a, c in zip(kernel_grads[:g], plain_grads[:g]))
        if not (err <= ATOL_GRAD and autograd_err <= ATOL_GRAD):
            raise AssertionError(f'dsnt_jsd_bwd disagrees with its plain version at '
                                 f'{shape_name(g, b, j, h, w, sigma, offset)}: max abs err {err}, '
                                 f'through the softmax {autograd_err} (atol {ATOL_GRAD})')
        if any(d is not None and torch.count_nonzero(d).item() for d in kernel_grads[g:]):
            raise AssertionError('dsnt_jsd_grouped passed a gradient to its targets')
        no_target = 'none' if all(d is None for d in kernel_grads[g:]) else 'zero'
        worst = max(worst, err, autograd_err)
        bound_ms, bound_by = bwd_bound(g, b * j, h * w)
        ms = median_ms(lambda: dsnt_jsd_bwd(hms, mus, grad, sigma))
        dev_ms = graph_ms(lambda: dsnt_jsd_bwd(hms, mus, grad, sigma))
        plain_ms = median_ms(lambda: dsnt_jsd_bwd_plain(hms, mus, grad, sigma))
        phase('kernels', f'dsnt_jsd_bwd {shape_name(g, b, j, h, w, sigma, offset)}: max abs err '
                         f'{err:.3g}, through the softmax {autograd_err:.3g} (atol {ATOL_GRAD}), '
                         f'target gradient {no_target}; kernel {ms * 1e3:.2f} us per call eager, '
                         f'{dev_ms * 1e3:.2f} us in a CUDA graph; plain {plain_ms * 1e3:.2f} us; '
                         f'bound {bound_ms * 1e3:.3f} us ({bound_by}); library n/a')
        if (g, b, h, w, offset) == MAIN_SHAPE:
            report.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        if (g, b, h, w, offset) == CHATTERBOX_SHAPE:
            report['chatterbox'] = dict(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by,
                                        max_abs_err=max(err, autograd_err))
    g, b, j, h, w, sigma, offset = MIXED_RECIPE_SHAPE
    hms, mus = dsnt_jsd_inputs(g, b, j, h, w, offset, seed=62, spread=MIXED_RECIPE_SPREAD)
    grad, two_d = mixed_recipe_grad(g, b, j, torch.Generator().manual_seed(63))
    dp = dsnt_jsd_bwd(hms, mus, grad, sigma)
    expected = dsnt_jsd_bwd_plain(hms, mus, grad, sigma)
    torch.cuda.synchronize()
    err = (dp - expected).abs().max().item()
    finite = bool(torch.isfinite(dp).all())
    zero_rows = all(not torch.count_nonzero(dp[i].reshape(b * j, -1)[two_d]).item()
                    for i in range(g) if i % 3)
    phase('datasets', f'dsnt_jsd_bwd on the mixed 2D/3D recipe\'s rows '
                      f'({shape_name(g, b, j, h, w, sigma, offset)}, target means in '
                      f'[-{MIXED_RECIPE_SPREAD}, {MIXED_RECIPE_SPREAD}], '
                      f'{int(two_d.sum())} rows of each zy/xz group with a zero upstream '
                      f'gradient): max abs err {err:.3g} (atol {ATOL_GRAD}), finite {finite}, '
                      f'those rows\' gradients exactly zero {zero_rows}; kernel '
                      f'{graph_ms(lambda: dsnt_jsd_bwd(hms, mus, grad, sigma)) * 1e3:.2f} us in '
                      f'a CUDA graph')
    if not (err <= ATOL_GRAD and finite and zero_rows):
        raise AssertionError('dsnt_jsd_bwd disagrees with its plain version on the mixed '
                             'recipe\'s rows')
    report['mixed_rows_max_abs_err'] = err
    report['max_abs_err'] = max(worst, err)
    return report


def sweep_phase(reports):
    """Both grouped kernels at 32x32 over SWEEP_ROWS rows, in a CUDA graph:
    a launch's fixed cost against its cost per row."""
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_bwd, dsnt_jsd_fwd

    fwd_us, bwd_us = {}, {}
    for g, b, j in SWEEP_ROWS:
        hms, mus = dsnt_jsd_inputs(g, b, j, 32, 32, 0, seed=g + b + j)
        grad = torch.randn(g, b * j, 4, device='cuda')
        rows = g * b * j
        fwd_us[rows] = graph_ms(lambda: dsnt_jsd_fwd(hms, mus, 1.0)) * 1e3
        bwd_us[rows] = graph_ms(lambda: dsnt_jsd_bwd(hms, mus, grad, 1.0)) * 1e3
        phase('sweep', f'{rows} rows of 32x32 ({g}x{b}x{j}): dsnt_jsd_fwd {fwd_us[rows]:.3f} us '
                       f'(bound {fwd_bound(g, b * j, 1024)[0] * 1e3:.3f}), dsnt_jsd_bwd '
                       f'{bwd_us[rows]:.3f} us (bound {bwd_bound(g, b * j, 1024)[0] * 1e3:.3f}) '
                       f'in a CUDA graph; {fwd_us[rows] / rows * 1e3:.3f} and '
                       f'{bwd_us[rows] / rows * 1e3:.3f} ns a row')
    for report, us in zip(reports, (fwd_us, bwd_us)):
        report['sweep_graph_us'] = us


def launch_counters():
    from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_bwd, dsnt_jsd_fwd

    return {'dsnt_jsd_fwd': dsnt_jsd_fwd, 'dsnt_jsd_bwd': dsnt_jsd_bwd}


def reset_counts():
    """Every kernel's launch count set to 0, just before a path runs."""
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


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
    counters = reset_counts()
    rows, stats = eval_3d.main(['--model', ckpt, '--dataset', 'synthetic-64', '--batch-size', '32',
                                '--precision', 'float32', '--ship', 'float32', '--device', 'cuda'])
    launches = read_counts(counters)
    expected = stats['batches']  # one grouped launch for 3 planes x 4 stages per batch
    phase('main', f"kernel launches {launches}, expected dsnt_jsd_fwd = 1 x "
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
    return launches, ckpt


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
CONV_WORDS = ('conv', 'gemm', 'xmma', 'fft', 'complex', 'dgrad', 'wgrad', 'fprop')
FFT_WORDS = ('fft', 'complex')
EVAL_GROUPS = [('convolutions', CONV_WORDS), ('of which FFT', FFT_WORDS),
               ('batch norm', ('batch_norm', 'bn_')), ('dsnt_jsd head', ('dsnt_jsd',)),
               ('softmax', ('softmax',)), ('copies and casts', ('copy',))]


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


def trace_phase(model, precision='float32', name='trace'):
    """Where one batch of 32 spends its device time: torch.profiler over one
    forward + masked loss (the eval bin's forward), kernels grouped by name."""
    from margipose_tpu_torch.bin.eval_3d import make_forward

    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=2).items()}
    forward = make_forward(model, 'jsd', precision)

    def step():
        forward(batch['input'], batch['target'], batch['joint_mask'], batch['valid_depth'])

    events, busy, window = profiled(step)
    report_trace(name, f'one batch of 32, forward + loss, {precision}', events, busy, window,
                 EVAL_GROUPS)
    return window, events


def parity_phase(model, name='parity'):
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
    phase(name, f'card vs CPU: heatmaps max abs err {hm_err:.3g} (atol 1e-4, peak value '
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
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    result = train_3d.main(['with', 'margipose_model', 'synthetic', 'epochs=1', 'batch_size=32',
                            f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']",
                            'val_examples=32', 'metrics_every=1', f'seed={seed}',
                            "precision='float32'", "ship='float32'",
                            f'out_dir={out_dir}', 'experiment_id=flagship'])
    launches = read_counts(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {'dsnt_jsd_fwd': steps + val_batches, 'dsnt_jsd_bwd': steps}
    phase('train', f'kernel launches {launches}, expected {expected} (one grouped launch each '
                   f'way a step for 3 planes x 4 stages; {steps} train steps, {val_batches} '
                   f'validation batch)')
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
                                '--batch-size', '32', '--precision', 'float32', '--device', 'cuda'])
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == 64):
        raise AssertionError('eval of the trained checkpoint gave non-finite metrics or loss')
    phase('train', f'bin.eval_3d on model-latest: overall {eval_3d.overall_metrics(rows)}, '
                   f'mean loss {stats["mean_loss"]}')
    return launches


def train_trace_phase(model, precision='float32', name='train trace'):
    """Where one flagship train step at batch 32 spends its device time:
    torch.profiler over the port's train step, and over its forward + loss
    alone (train mode, no autograd graph: the same kernels), so that the
    backward's share is the difference."""
    from margipose_tpu_torch.models.margipose import margipose_masked_loss
    from margipose_tpu_torch.parallel.precision import compute_dtype_scope
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    model = copy.deepcopy(model)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, max_iters=100))
    step = make_train_step('jsd', precision)
    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=5).items()}
    step(state, batch)  # cuDNN's algorithm search for the train shapes

    def forward():
        with torch.no_grad(), compute_dtype_scope(precision, 'cuda'):
            margipose_masked_loss(model.train()(batch['input'])[1], batch['target'],
                                  batch['joint_mask'], batch['valid_depth'])

    groups = [('convolutions', CONV_WORDS), ('batch norm', ('batch_norm', 'bn_')),
              ('dsnt_jsd_fwd', ('dsnt_jsd_fwd',)), ('dsnt_jsd_bwd', ('dsnt_jsd_bwd',)),
              ('softmax', ('softmax',)), ('optimiser', ('multi_tensor', 'foreach', 'sgd')),
              ('of which FFT', FFT_WORDS), ('copies and casts', ('copy',))]
    fwd_events, fwd_busy, fwd_window = profiled(forward)
    events, busy, window = profiled(lambda: step(state, batch))
    report_trace(name, f'forward + loss alone, batch 32, {precision}', fwd_events, fwd_busy,
                 fwd_window, groups[:2] + groups[6:])
    report_trace(name, f'one train step of 32, {precision}', events, busy, window, groups)
    if events and fwd_events:
        bwd_conv = kernel_ms(events, CONV_WORDS) - kernel_ms(fwd_events, CONV_WORDS)
        bwd_bn = kernel_ms(events, groups[1][1]) - kernel_ms(fwd_events, groups[1][1])
        rest = busy - sum(kernel_ms(events, words) for _, words in groups[:6])
        phase(name, f'backward + optimiser {busy - fwd_busy:.3f} ms of kernels: '
                    f'convolutions {bwd_conv:.3f} ms (dgrad, wgrad), batch norm '
                    f'{bwd_bn:.3f} ms; kernels in no group above {rest:.3f} ms '
                    f'(elementwise, ReLU, copies)')


def train_step_state(model, device, batch, frozen=None):
    """The loss and the state_dict (float64, on the CPU) after one 1cycle
    step at ``batch`` from ``model``'s weights, float32 on ``device``;
    ``frozen`` names a batch norm whose gradients are zeroed (a planted
    fault)."""
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    m = copy.deepcopy(model).to(device, torch.float32)
    if frozen:
        bn = m.get_submodule(frozen)
        for p in (bn.weight, bn.bias):
            p.register_hook(torch.zeros_like)
    state = TrainState(m, make_optimiser('1cycle', m.parameters(), 1.0, max_iters=10))
    metrics = make_train_step('jsd')(state, {
        k: v.to(device, torch.float32) if v.is_floating_point() else v.to(device)
        for k, v in batch.items()})
    return float(metrics['loss']), {k: v.detach().cpu().double()
                                    for k, v in m.state_dict().items()}


def worst_update_share(got, want, initial):
    """The worst parameter tensor's distance from ``want`` as a share of its
    tolerance: 10% of the update ``want`` made to it, in L2, plus 1e-6 RMS
    (a tensor the step leaves still must stay within 1e-6 RMS). Returns
    (share, tensor)."""
    return max(((got[k] - want[k]).norm().item() / (
        0.1 * (want[k] - initial[k]).norm().item() + 1e-6 * want[k].numel() ** 0.5), k)
        for k in want if 'running_' not in k and not k.endswith('num_batches_tracked'))


def worst_row_share(got, want, initial, n_joints=17):
    """The second rule, for faults confined to a few elements: each joint's
    row (the output channel) of every convolution weight with one output
    channel per joint (the columns' last residual blocks, Chatterbox's last
    convolutions) within 10% of the update ``want`` made to that row in L2,
    plus 1e-6 RMS. Batch norm's per-joint scales and shifts are single
    elements, which the L2 rule's note says rounding moves too far to hold
    one by one. Returns (share, tensor, row)."""
    shares = []
    for k in want:
        if want[k].dim() < 4 or want[k].shape[0] != n_joints:
            continue
        got_r, want_r, init_r = (t[k].reshape(n_joints, -1) for t in (got, want, initial))
        tol = 0.1 * (want_r - init_r).norm(dim=1) + 1e-6 * want_r.shape[1] ** 0.5
        share = (got_r - want_r).norm(dim=1) / tol
        row = int(share.argmax())
        shares.append((share[row].item(), k, row))
    return max(shares)


def train_parity_phase(model, name='train parity'):
    """One train step at batch 2 from the same weights and batch on the card
    and on the CPU, float32, TF32 off. Tolerances:
      loss        rtol 1e-3, as the eval parity;
      parameters  each tensor within 10% of the CPU step's update to it in
                  L2, plus 1e-6 RMS for a tensor the step leaves still:
                  train-mode batch norm over few values a channel amplifies
                  rounding into single elements (Chatterbox's float32 step
                  at batch 2 moves elements by up to a third of a tensor's
                  largest update from a float64 step, on the card and the
                  CPU alike; PERF.md §6), not into whole tensors;
      BN buffers  rtol 1e-4, atol 1e-5.
    Then the rule's power: the same step on the card with a fault planted,
    one example's loss dropped or one batch norm's gradients zeroed, must
    fail it. A fault confined to a few elements, one joint of one example
    dropped from the loss, is read against the L2 rule and against the
    joint-row rule (``worst_row_share``), which the sound step must pass and
    the fault must fail (one of the two rules catches it)."""
    batch = flagship_batch(2, seed=3)
    initial = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
    loss_gpu, gpu = train_step_state(model, 'cuda', batch)
    loss_cpu, cpu = train_step_state(model, 'cpu', batch)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    share = worst_update_share(gpu, cpu, initial)
    row_share = worst_row_share(gpu, cpu, initial)
    still = [k for k in cpu if 'running_' not in k and not k.endswith('num_batches_tracked')
             and (cpu[k] - initial[k]).norm().item() <= 1e-6 * cpu[k].numel() ** 0.5]
    moved_still = max([(gpu[k] - initial[k]).norm().item() / gpu[k].numel() ** 0.5
                       for k in still], default=0.0)
    worst_buffer = max(((gpu[k] - cpu[k]).abs() / (1e-5 + 1e-4 * cpu[k].abs())).max().item()
                       for k in cpu if 'running_' in k)
    phase(name, f'one step at batch 2, card vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f}, rel '
                f'err {loss_rel:.3g} (rtol 1e-3); worst parameter tensor at {share[0]:.4f} of '
                f'10% of its update + 1e-6 RMS ({share[1]}); {len(still)} tensors the CPU left '
                f'still, moved on the card by {moved_still:.3g} RMS at most; worst BN buffer at '
                f'{worst_buffer:.3g} of its tolerance')
    phase(name, f'joint-row rule: worst joint row at {row_share[0]:.4f} of 10% of its update + '
                f'1e-6 RMS ({row_share[1]}, row {row_share[2]})')
    dropped = {**batch, 'joint_mask': batch['joint_mask'].clone()}
    dropped['joint_mask'][0] = 0
    bns = [n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    frozen = bns[len(bns) // 2]
    faults = {'example 0 dropped from the loss': train_step_state(model, 'cuda', dropped)[1],
              f'{frozen} gradients zeroed': train_step_state(model, 'cuda', batch, frozen)[1]}
    caught = True
    for fault, state in faults.items():
        fault_share = worst_update_share(state, cpu, initial)
        caught = caught and fault_share[0] > 1
        phase(name, f'planted fault, {fault}: worst parameter tensor at {fault_share[0]:.4g} of '
                    f'its tolerance ({fault_share[1]})')
    one_joint = {**batch, 'joint_mask': batch['joint_mask'].clone()}
    one_joint['joint_mask'][0, DROPPED_JOINT] = 0
    state = train_step_state(model, 'cuda', one_joint)[1]
    joint_share, joint_rows = worst_update_share(state, cpu, initial), worst_row_share(state, cpu,
                                                                                       initial)
    phase(name, f'planted fault confined to a few elements, joint {DROPPED_JOINT} of example 0 '
                f'dropped from the loss: L2 rule {joint_share[0]:.4g} ({joint_share[1]}), '
                f'{"caught" if joint_share[0] > 1 else "passed"}; joint-row rule '
                f'{joint_rows[0]:.4g} ({joint_rows[1]}, row {joint_rows[2]}), '
                f'{"caught" if joint_rows[0] > 1 else "passed"}')
    if not (loss_rel <= 1e-3 and share[0] <= 1 and worst_buffer <= 1 and row_share[0] <= 1):
        raise AssertionError('a train step on the card disagrees with one on the CPU')
    if not (caught and max(joint_share[0], joint_rows[0]) > 1):
        raise AssertionError('the train parity rules passed a step with a planted fault')


def statistically_close(a, b):
    """The bounds the JAX package holds its bf16 forward to against its f32
    one (tests/test_precision.py): median < 0.02, mean < 0.05, no coordinate
    further than 0.5 (a near-saturated softmax can move one by a heatmap
    cell). Returns (ok, median, mean, max)."""
    err = (a.double() - b.double()).abs()
    med, mean, worst = err.median().item(), err.mean().item(), err.max().item()
    return med < 0.02 and mean < 0.05 and worst <= 0.5, med, mean, worst


def bf16_eval_phase(model, ckpt):
    """The flagship eval path in bf16 with uint8 upload through bin.eval_3d,
    bf16 against float32 coordinates on one batch of 32, and a profiled
    bf16 batch."""
    from margipose_tpu_torch.bin import eval_3d

    counters = reset_counts()
    rows, stats = eval_3d.main(['--model', ckpt, '--dataset', 'synthetic-96', '--batch-size', '32',
                                '--precision', 'bfloat16', '--ship', 'uint8', '--device', 'cuda'])
    launches = read_counts(counters)
    expected = {'dsnt_jsd_fwd': stats['batches'], 'dsnt_jsd_bwd': 0}
    phase('bf16 eval', f'kernel launches {launches}, expected {expected}')
    if launches != expected or not stats['batches']:
        raise AssertionError(f'bf16 eval path launched {launches}, expected {expected}')
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == 96):
        raise AssertionError('bf16 eval gave non-finite metrics or loss, or lost examples')
    ms = [s * 1e3 for s in stats['batch_seconds']]
    phase('bf16 eval', f'device ms per batch of 32: {", ".join(f"{m:.3f}" for m in ms)}; '
                       f'{32 * len(ms) / (sum(ms) / 1e3):.1f} images/s; mean loss '
                       f'{stats["mean_loss"]}; overall {eval_3d.overall_metrics(rows)}')

    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=4).items()}
    xyz = {p: eval_3d.make_forward(model, 'jsd', p)(batch['input'], batch['target'],
                                                    batch['joint_mask'], batch['valid_depth'])[0]
           for p in ('float32', 'bfloat16')}
    ok, med, mean, worst = statistically_close(xyz['bfloat16'], xyz['float32'])
    phase('bf16 eval', f'bf16 vs float32 coordinates on one batch of 32: median abs err {med:.4g} '
                       f'(< 0.02), mean {mean:.4g} (< 0.05), max {worst:.4g} (<= 0.5)')
    if not ok or xyz['bfloat16'].dtype != torch.float32:
        raise AssertionError('bf16 coordinates outside the bounds of the float32 ones')
    window, events = trace_phase(model, 'bfloat16', 'bf16 trace')
    fft = kernel_ms(events, FFT_WORDS)
    phase('bf16 trace', 'cuDNN FFT convolutions in bf16: ' + (
        'not measured (no device events)' if not events else
        'none' if not fft else f'{fft:.3f} ms'))
    return launches


def multicrop_phase(ckpt):
    """bin.eval_3d --multicrop: each example's 10 crops in one forward."""
    from margipose_tpu_torch.bin import eval_3d

    counters = reset_counts()
    rows, stats = eval_3d.main(['--model', ckpt, '--dataset', f'synthetic-{MULTICROP_EXAMPLES}',
                                '--multicrop', '--precision', 'float32', '--device', 'cuda'])
    launches = read_counts(counters)
    expected = {'dsnt_jsd_fwd': MULTICROP_EXAMPLES, 'dsnt_jsd_bwd': 0}
    phase('multicrop', f'kernel launches {launches}, expected {expected} (one per example of '
                       f'10 crops)')
    if launches != expected or len(rows['mpjpe']) != MULTICROP_EXAMPLES:
        raise AssertionError(f'multicrop eval launched {launches} for {len(rows["mpjpe"])} '
                             f'examples, expected {expected}')
    if not all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m]):
        raise AssertionError('multicrop eval gave non-finite metrics')
    ms = [s * 1e3 for s in stats['batch_seconds']]
    phase('multicrop', f'device ms per example (10 crops): {", ".join(f"{m:.3f}" for m in ms)}; '
                       f'overall {eval_3d.overall_metrics(rows)}')
    return launches


def bf16_train_phase():
    """The flagship train path through bin.train_3d in bf16 with uint8
    upload: both kernels once a step, and the saved weights, BN statistics
    and optimiser state float32."""
    from margipose_tpu_torch.bin import train_3d
    from margipose_tpu_torch.train import checkpoint

    out_dir = os.path.join(WORK, 'train_bf16')
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, val_batches = TRAIN_STEPS, 1
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    result = train_3d.main(['with', 'margipose_model', 'synthetic', 'epochs=1', 'batch_size=32',
                            f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']",
                            'val_examples=32', 'metrics_every=1', 'seed=7',
                            "precision='bfloat16'", "ship='uint8'",
                            f'out_dir={out_dir}', 'experiment_id=flagship'])
    launches = read_counts(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {'dsnt_jsd_fwd': steps + val_batches, 'dsnt_jsd_bwd': steps}
    phase('bf16 train', f'kernel launches {launches}, expected {expected}')
    if launches != expected or result['step'] != steps:
        raise AssertionError(f'bf16 train path launched {launches} in {result["step"]} steps, '
                             f'expected {expected} in {steps}')
    payload = checkpoint.load_payload(os.path.join(out_dir, 'flagship', 'model-latest'))
    dtypes = {v.dtype for k, v in payload['model'].items() if not k.endswith('num_batches_tracked')}
    dtypes |= {buf.dtype for st in payload['optimiser']['optimiser']['state'].values()
               for buf in st.values() if torch.is_tensor(buf)}
    if dtypes != {torch.float32} or not math.isfinite(result['train_loss']):
        raise AssertionError(f'bf16 train state holds {dtypes}, loss {result["train_loss"]}')
    ms = [s * 1e3 for s in result['step_seconds']]
    steady = ms[1:]
    phase('bf16 train', f'train loss {result["train_loss"]:.6f}; weights, BN statistics and '
                        f'optimiser state {sorted(str(d) for d in dtypes)}')
    phase('bf16 train', f'device ms per step of 32: first {ms[0]:.3f} (cuDNN\'s algorithm '
                        f'search), then {", ".join(f"{m:.3f}" for m in steady)}; '
                        f'{32 * len(steady) / (sum(steady) / 1e3):.1f} images/s on the device '
                        f'after the first step; data_load_time {result["data_load_time"]:.4f} s '
                        f'a step; peak memory {peak_gib:.2f} GiB')
    return launches


def infer_phase(model, desc=None, name='infer'):
    """bin.infer_single.infer_image on resources/man_running.jpg, one crop
    and ten, on the card against the CPU, float32 (TF32 off)."""
    import PIL.Image

    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
    from margipose_tpu_torch.bin.infer_single import infer_image
    from margipose_tpu_torch.models import Default_MargiPose_Desc

    desc = desc or Default_MargiPose_Desc
    set_float32_parity_mode()
    cpu_model = copy.deepcopy(model).cpu()
    image = PIL.Image.open(IMAGE)
    counters = reset_counts()
    for multicrop in (False, True):
        t0 = time.perf_counter()
        inp, coords = infer_image(model, image, desc, multicrop, 'cuda')
        card_s = time.perf_counter() - t0
        _, cpu_coords = infer_image(cpu_model, image, desc, multicrop, 'cpu')
        err = float(np.abs(coords - cpu_coords).max())
        phase(name, f'{"10 crops" if multicrop else "one crop"}: input {inp.shape}, coords '
                       f'{coords.shape}, card vs CPU max abs err {err:.3g} (atol 1e-4); '
                       f'{card_s * 1e3:.1f} ms on the host clock, card')
        if not (coords.shape == (17, 3) and np.isfinite(coords).all() and err <= 1e-4):
            raise AssertionError('infer on the card disagrees with the CPU')
    launches = read_counts(counters)
    phase(name, f'kernel launches {launches} (the JAX infer has no Pallas either: DSNT in '
                f'plain ops, no loss)')
    return launches


def _post(url, body):
    req = urllib.request.Request(url, data=body, method='POST')
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    return thread, f'http://{host}:{port}'


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def serve_phase(ckpt):
    """bin.serve at batch 8 in bf16 on the flagship: SERVE_REQUESTS
    concurrent /predict requests, the other endpoints, the served
    coordinates against a direct runner call on the same letterboxed
    pixels; then one float32 request against the CPU's runner."""
    import PIL.Image

    from margipose_tpu_torch.bin import serve

    rng = np.random.RandomState(11)
    with open(IMAGE, 'rb') as f:
        bodies = [f.read()]
    photo = PIL.Image.open(IMAGE).convert('RGB')
    for _ in range(SERVE_REQUESTS - 1):  # crops of the photo at other sizes, as PNG
        w, h = rng.randint(160, 640), rng.randint(160, 640)
        x, y = rng.randint(0, photo.width - w // 2), rng.randint(0, photo.height - h // 2)
        buf = io.BytesIO()
        photo.crop((x, y, x + w, y + h)).save(buf, format='PNG')
        bodies.append(buf.getvalue())

    counters = reset_counts()
    t0 = time.perf_counter()
    server = serve.create_server(ckpt, port=0, batch_size=8, max_wait_ms=5.0,
                                 precision='bfloat16', device='cuda')
    phase('serve', f'bf16 server up at batch 8 (load + warmup {time.perf_counter() - t0:.2f} s)')
    thread, url = _serve(server)
    try:
        health, info = _get(url + '/healthz'), _get(url + '/info')
        with concurrent.futures.ThreadPoolExecutor(SERVE_REQUESTS) as pool:
            replies = list(pool.map(lambda b: _post(url + '/predict', b), bodies))
        metrics = _get(url + '/metrics')
        alone = [_post(url + '/predict', b)['latency_ms'] for b in bodies[:SERVE_ALONE]]
    finally:
        _stop(server, thread)
    launches = read_counts(counters)
    if health != {'status': 'ok'} or info['batch_size'] != 8 or info['precision'] != 'bfloat16':
        raise AssertionError(f'serve: /healthz {health}, /info {info}')
    coords = [np.array(list(r['joints'].values())) for r in replies]
    runner, specs, _ = serve.make_runner(ckpt, 'bfloat16', 'cuda')
    w, h = specs.input_specs.width, specs.input_specs.height
    worst, runner_ms = 0.0, []
    for body, got in zip(bodies, coords):
        pixels = serve.letterbox_uint8(PIL.Image.open(io.BytesIO(body)), w, h)
        t0 = time.perf_counter()
        direct = runner(np.stack([pixels] * 8))[0]
        runner_ms.append((time.perf_counter() - t0) * 1e3)
        worst = max(worst, float(np.abs(got - direct).max()))
    lat = metrics.get('latency_ms', {})
    phase('serve', f'{len(replies)} concurrent /predict: {metrics["ok_total"]} ok in '
                   f'{metrics["batches_total"]} batches, mean batch occupancy '
                   f'{metrics.get("batch_occupancy_mean")} of 8; latency p50 {lat.get("p50")} ms, '
                   f'p95 {lat.get("p95")} ms, max {lat.get("max")} ms (host clock, /metrics)')
    phase('serve', f'then {SERVE_ALONE} requests one at a time: latency '
                   f'{", ".join(f"{ms:.3f}" for ms in alone)} ms')
    phase('serve', f'served vs a direct runner call on the same pixels: max abs diff {worst:.3g} '
                   f'(atol 1e-5); kernel launches {launches}; a direct runner call at batch 8 '
                   f'(upload, forward, read-back) {runner_ms[0]:.3f} ms the first on this thread, '
                   f'then median {float(np.median(runner_ms[1:])):.3f} ms')
    if not (metrics['ok_total'] == SERVE_REQUESTS and metrics['errors_total'] == 0
            and all(c.shape == (17, 3) and np.isfinite(c).all() for c in coords)
            and worst <= 1e-5):
        raise AssertionError(f'serve: metrics {metrics}, served vs direct {worst}')

    server = serve.create_server(ckpt, port=0, batch_size=1, precision='float32', device='cuda')
    thread, url = _serve(server)
    try:
        got = np.array(list(_post(url + '/predict', bodies[0])['joints'].values()))
    finally:
        _stop(server, thread)
    cpu_runner, _, _ = serve.make_runner(ckpt, 'float32', 'cpu')
    pixels = serve.letterbox_uint8(PIL.Image.open(io.BytesIO(bodies[0])), w, h)
    err = float(np.abs(got - cpu_runner(pixels[None])[0]).max())
    phase('serve', f'one float32 request on the card vs the CPU runner: max abs err {err:.3g} '
                   f'(atol 1e-4)')
    if not err <= 1e-4:
        raise AssertionError('a float32 request served on the card disagrees with the CPU')
    return launches


def host_ops_phase():
    """The host-ops library g++ built in the build phase against the port's
    PIL path on the photo: the warp within 1 uint8 LSB (PIL rounds its
    intermediates), the fused warp + colour jitter within a mean of 3 LSBs
    (PIL quantises after each colour pass; the JAX package's note and
    tests/test_native.py allow that)."""
    import PIL.Image

    from margipose_tpu_torch import native
    from margipose_tpu_torch.geometry.transforms import (
        adjust_colour_pil,
        build_affine,
        warp_image_pil,
    )

    if not native.available():
        raise AssertionError('the host-ops library is disabled (MARGIPOSE_DISABLE_NATIVE)')
    photo = PIL.Image.open(IMAGE).convert('RGB')
    src = np.asarray(photo)
    # a rotated, mirrored 256 px crop whose footprint lies inside the photo
    affine = build_affine(dict(centre_x=256, centre_y=250, rotation=17.0, scale=0.6, hflip=True,
                               in_width=photo.width, in_height=photo.height, out_width=256,
                               out_height=256))
    jitter = dict(brightness=1.15, contrast=0.9, saturation=1.2, hue=0.05)
    timings = {}

    def timed(name, fn, reps=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        timings[name] = (time.perf_counter() - t0) / reps * 1e3
        return out

    warped = timed('native warp', lambda: native.warp_rgb(src, affine, (256, 256)))
    pil = timed('PIL warp', lambda: np.asarray(warp_image_pil(photo, affine, (256, 256))))
    fused = timed('native warp + colour', lambda: native.warp_colour_norm(
        src, affine, (256, 256), **jitter))
    pil_fused = timed('PIL warp + colour', lambda: np.asarray(adjust_colour_pil(
        warp_image_pil(photo, affine, (256, 256)), **jitter)))
    warp_err = int(np.abs(warped.astype(int) - pil.astype(int)).max())
    fused_err = float(np.abs(fused - pil_fused / np.float32(255.0)).mean() * 255.0)
    phase('host ops', f'warp_rgb vs PIL: max {warp_err} uint8 LSB (<= 1); warp_colour_norm vs '
                      f'PIL warp + colour passes: mean {fused_err:.3f} LSB (< 3)')
    phase('host ops', 'host ms per 256x256 example (one thread, host CPU): '
          + ', '.join(f'{k} {v:.3f}' for k, v in timings.items()))
    if not (warp_err <= 1 and fused_err < 3.0):
        raise AssertionError('the host-ops library disagrees with the PIL path')


def stem_desc(variant):
    return {'type': 'margipose', 'version': '6.0.1',
            'settings': {'n_stages': 4, 'axis_permutation': True, 'feature_extractor': variant,
                         'pixelwise_loss': 'jsd'}}


def eval_window_ms(model, precision):
    """Device ms of one forward + masked loss at batch 32 (CUDA events, after
    a warm-up)."""
    from margipose_tpu_torch.bin.eval_3d import make_forward

    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=2).items()}
    forward = make_forward(model, 'jsd', precision)
    args = (batch['input'], batch['target'], batch['joint_mask'], batch['valid_depth'])
    forward(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    forward(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def stems_phase():
    """MargiPose with each ResNet stem at 4 stages and 256 px, seeded random
    weights with calibrated BN: card against CPU at batch 2, a batch of 32
    timed; resnet34 traced; then the resnet34 train path with a grafted
    backbone."""
    from margipose_tpu_torch.models import create_model

    for variant in STEMS:
        g = torch.Generator().manual_seed(20)
        model = create_model(stem_desc(variant), generator=g).cuda()
        randomize_batch_norm(model, torch.randn(8, 3, 256, 256, generator=g).cuda(), g)
        parity_phase(model, f'{variant} parity')
        phase(f'{variant}', f'one batch of 32, forward + loss: {eval_window_ms(model, "float32"):.3f} '
                            f'ms float32, {eval_window_ms(model, "bfloat16"):.3f} ms bf16 (CUDA '
                            f'events)')
        if variant == 'resnet34':
            trace_phase(model, 'float32', 'resnet34 trace')
            trace_phase(model, 'bfloat16', 'resnet34 bf16 trace')
            train_trace_phase(model, 'float32', 'resnet34 train trace')
            train_trace_phase(model, 'bfloat16', 'resnet34 bf16 train trace')
        del model
    return stem_train_phase()


def write_backbone(path, variant, seed):
    """A torchvision-format backbone state_dict of seeded random tensors:
    conv1, bn1, layer1, layer2 at the stem's shapes, and a layer3 block and
    a classifier that the graft ignores. Returns it."""
    from margipose_tpu_torch.models.resnet import ResNetStem

    gen = torch.Generator().manual_seed(seed)

    def draw(key, value):
        if value.dtype == torch.int64:  # num_batches_tracked
            return value
        noise = torch.randn(value.shape, generator=gen)
        if value.dim() == 4:  # conv weights, about Kaiming's scale
            return noise * (2.0 / value[0].numel()) ** 0.5
        if key.endswith('running_var') or key.endswith('weight'):
            return 1.0 + 0.2 * noise.abs()
        return 0.1 * noise  # BN biases and running means

    heads = {'0': 'conv1', '1': 'bn1', '4': 'layer1', '5': 'layer2'}
    backbone = {}
    for key, value in ResNetStem(variant).state_dict().items():
        head, _, rest = key.partition('.')
        if head in heads:
            backbone[f'{heads[head]}.{rest}'] = draw(key, value)
    backbone['layer3.0.conv1.weight'] = torch.randn(256, 128, 3, 3, generator=gen)
    backbone['fc.weight'] = torch.randn(1000, 512, generator=gen)
    torch.save(backbone, path)
    return backbone


def train_bin_phase(name, words, steps, experiment_id):
    """bin.train_3d on ``words`` at batch 32 for ``steps`` steps and one
    validation batch: both kernels once a step (the forward also once for the
    validation batch). Returns (launches, result, checkpoint directory)."""
    from margipose_tpu_torch.bin import train_3d

    out_dir = os.path.join(WORK, experiment_id)
    shutil.rmtree(out_dir, ignore_errors=True)
    counters = reset_counts()
    result = train_3d.main(['with', *words, 'epochs=1', 'batch_size=32',
                            f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']",
                            'val_examples=32', 'metrics_every=1', 'seed=9', f'out_dir={out_dir}',
                            f'experiment_id={experiment_id}'])
    launches = read_counts(counters)
    expected = {'dsnt_jsd_fwd': steps + 1, 'dsnt_jsd_bwd': steps}
    phase(name, f'kernel launches {launches}, expected {expected}')
    with open(os.path.join(out_dir, experiment_id, 'metrics.jsonl')) as f:
        val_loss = json.loads(f.readline())['val_loss']
    if launches != expected or result['step'] != steps:
        raise AssertionError(f'{name} launched {launches} in {result["step"]} steps, '
                             f'expected {expected} in {steps}')
    if not (math.isfinite(result['train_loss']) and math.isfinite(val_loss)):
        raise AssertionError(f'{name}: train loss {result["train_loss"]}, val loss {val_loss}')
    ms = [s * 1e3 for s in result['step_seconds']]
    phase(name, f'train loss {result["train_loss"]:.6f}, val loss {val_loss:.6f}; device ms per '
                f'step of 32: first {ms[0]:.3f} (cuDNN\'s algorithm search), then '
                f'{", ".join(f"{m:.3f}" for m in ms[1:])}; data_load_time '
                f'{result["data_load_time"]:.4f} s a step')
    return launches, result, os.path.join(out_dir, experiment_id, 'model-latest')


def stem_train_phase():
    """bin.train_3d on MargiPose with the resnet34 stem, 4 stages, the stem
    grafted from a backbone file (pretrained_stem): after STEM_TRAIN_STEPS
    steps the stem lies nearer the backbone's weights than the fresh draw
    the run would have started from without the graft."""
    from margipose_tpu_torch.models import create_model
    from margipose_tpu_torch.train import checkpoint

    path = os.path.join(WORK, 'resnet34-backbone.pth')
    os.makedirs(WORK, exist_ok=True)
    backbone = write_backbone(path, 'resnet34', seed=21)
    launches, _, ckpt_dir = train_bin_phase(
        'stem train', ['margipose_model', 'synthetic',
                       "model_desc={'settings': {'feature_extractor': 'resnet34'}}",
                       f"pretrained_stem='{path}'", "precision='float32'", "ship='float32'"],
        STEM_TRAIN_STEPS, 'resnet34')
    saved = checkpoint.load_payload(ckpt_dir)['model']['inner.in_cnn.4.2.conv2.weight']
    fresh = create_model(stem_desc('resnet34'), generator=torch.Generator().manual_seed(9))

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()

    to_backbone = cosine(saved, backbone['layer1.2.conv2.weight'])
    to_fresh = cosine(saved, fresh.state_dict()['inner.in_cnn.4.2.conv2.weight'])
    phase('stem train', f'layer1.2.conv2 after {STEM_TRAIN_STEPS} steps: cosine {to_backbone:.4f} '
                        f'to the backbone\'s, {to_fresh:.4f} to the fresh draw (seed 9)')
    if not to_backbone > max(0.5, to_fresh):
        raise AssertionError('the resnet34 stem did not start from the pretrained backbone')
    return {'stem_train': launches}


def eval_bin_phase(name, ckpt, precision, ship, examples=64):
    """bin.eval_3d on synthetic-``examples`` at batch 32: the forward kernel
    once a batch, finite metrics. Returns the launches."""
    from margipose_tpu_torch.bin import eval_3d

    counters = reset_counts()
    rows, stats = eval_3d.main(['--model', ckpt, '--dataset', f'synthetic-{examples}',
                                '--batch-size', '32', '--precision', precision, '--ship', ship,
                                '--device', 'cuda'])
    launches = read_counts(counters)
    expected = {'dsnt_jsd_fwd': stats['batches'], 'dsnt_jsd_bwd': 0}
    phase(name, f'kernel launches {launches}, expected {expected}')
    if launches != expected or not stats['batches']:
        raise AssertionError(f'{name} launched {launches}, expected {expected}')
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == examples):
        raise AssertionError(f'{name} gave non-finite metrics or loss, or lost examples')
    ms = [s * 1e3 for s in stats['batch_seconds']]
    phase(name, f'device ms per batch of 32: {", ".join(f"{m:.3f}" for m in ms)}; mean loss '
                f'{stats["mean_loss"]}; overall {eval_3d.overall_metrics(rows)}')
    return launches


@torch.no_grad()
def chatterbox(device):
    """Chatterbox from seeded random weights: calibrated, perturbed BN stats
    and the heads' last convolutions scaled down (soft heatmaps)."""
    from margipose_tpu_torch.models import Default_Chatterbox_Desc, create_model

    g = torch.Generator().manual_seed(30)
    model = create_model(Default_Chatterbox_Desc, generator=g).to(device)
    calibrate_bn(model, torch.randn(8, 3, 256, 256, generator=g).to(device), g)
    for head, conv in (('xy_hm_cnn', model.xy_hm_cnn.hm_conv),
                       ('zy_hm_cnn', model.zy_hm_cnn.up_convs[7]),
                       ('xz_hm_cnn', model.xz_hm_cnn.up_convs[7])):
        conv.weight *= CHATTERBOX_HEAD_SCALES[head]
    return model.eval()


def chatterbox_phase():
    """Chatterbox through its entry points: eval (float32, bf16 with uint8
    upload), train (the chatterbox_model preset), infer; card against CPU;
    traces."""
    from margipose_tpu_torch.checkpoint import save_model
    from margipose_tpu_torch.models import Default_Chatterbox_Desc

    model = chatterbox('cuda')
    ckpt = os.path.join(WORK, 'chatterbox-random.pth')
    save_model(ckpt, model, Default_Chatterbox_Desc)
    by_path = {'chatterbox_eval': eval_bin_phase('chatterbox eval', ckpt, 'float32', 'float32'),
               'chatterbox_eval_bf16': eval_bin_phase('chatterbox bf16 eval', ckpt, 'bfloat16',
                                                      'uint8')}
    trace_phase(model, 'float32', 'chatterbox trace')
    trace_phase(model, 'bfloat16', 'chatterbox bf16 trace')
    parity_phase(model, 'chatterbox parity')
    by_path['chatterbox_train'], _, _ = train_bin_phase(
        'chatterbox train', ['chatterbox_model', 'synthetic', "precision='float32'",
                             "ship='float32'"], CHATTERBOX_STEPS, 'chatterbox')
    train_trace_phase(model, 'float32', 'chatterbox train trace')
    train_trace_phase(model, 'bfloat16', 'chatterbox bf16 train trace')
    train_parity_phase(model, 'chatterbox train parity')
    by_path['chatterbox_infer'] = infer_phase(model, Default_Chatterbox_Desc, 'chatterbox infer')
    return by_path


def mixed_batch(seed):
    """One batch of 2 as the mixed 2D/3D recipe gives it: an MPI-INF-3DHP
    example (valid_depth 1) and an MPII one (valid_depth 0) with half its
    joints masked and some targets off the map."""
    batch = flagship_batch(2, seed)
    batch['joint_mask'] = torch.ones(2, 17)
    batch['joint_mask'][1, ::2] = 0
    batch['target'][1, [0, 1, 2, 7, 8], :2] = torch.tensor([2.5, -1.8])
    batch['valid_depth'] = torch.tensor([1, 0])
    return batch


def mixed_train_parity_phase(model):
    """One flagship train step at batch 2 on a mixed 2D/3D batch, card
    against CPU, under train_parity_phase's rules."""
    batch = mixed_batch(seed=12)
    initial = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
    loss_gpu, gpu = train_step_state(model, 'cuda', batch)
    loss_cpu, cpu = train_step_state(model, 'cpu', batch)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    share, row_share = worst_update_share(gpu, cpu, initial), worst_row_share(gpu, cpu, initial)
    worst_buffer = max(((gpu[k] - cpu[k]).abs() / (1e-5 + 1e-4 * cpu[k].abs())).max().item()
                       for k in cpu if 'running_' in k)
    finite = all(torch.isfinite(v).all() for v in gpu.values()) and math.isfinite(loss_gpu)
    phase('datasets', f'mixed 2D/3D batch of 2 (valid_depth 1 and 0, half the 2D example\'s '
                      f'joints masked, 5 targets off the map), one train step card vs CPU: loss '
                      f'{loss_gpu:.6f} vs {loss_cpu:.6f}, rel err {loss_rel:.3g} (rtol 1e-3); worst '
                      f'parameter tensor at {share[0]:.4f} of 10% of its update + 1e-6 RMS '
                      f'({share[1]}); worst joint row at {row_share[0]:.4f} ({row_share[1]}, row '
                      f'{row_share[2]}); worst BN buffer at {worst_buffer:.3g}; finite {finite}')
    if not (finite and loss_rel <= 1e-3 and share[0] <= 1 and row_share[0] <= 1
            and worst_buffer <= 1):
        raise AssertionError('a mixed 2D/3D train step on the card disagrees with the CPU\'s')


def cudnn_policy_phase(model):
    """Eval and infer set cuDNN's deterministic algorithms, as the JAX bins
    do. One forward + loss at batch 32 in float32 and bf16 under each policy
    in turn, before anything else in the process has run a timed search:
    heuristics (the process's default, which eval and infer kept before
    they set the policy), deterministic, timed search (the train bin's), and
    heuristics again once the search has run (CUDA events; the median of
    three windows, each after a warm-up that includes any search)."""
    cudnn = torch.backends.cudnn
    before = (cudnn.benchmark, cudnn.deterministic)
    t0 = time.perf_counter()
    try:
        for precision in ('float32', 'bfloat16'):
            times = []
            for label, benchmark, deterministic in (
                    ('heuristics', False, False),
                    ('deterministic (eval, infer)', False, True),
                    ('timed search (train)', True, False),
                    ('heuristics after the search', False, False)):
                cudnn.benchmark, cudnn.deterministic = benchmark, deterministic
                ms = sorted(eval_window_ms(model, precision) for _ in range(3))[1]
                times.append(f'{label} {ms:.3f} ms')
            phase('cudnn policy', f'one batch of 32, forward + loss, {precision}: '
                                  + '; '.join(times))
        phase('cudnn policy', f'took {time.perf_counter() - t0:.1f} s')
    finally:
        cudnn.benchmark, cudnn.deterministic = before


def capture_stdout(fn, *args):
    """``fn(*args)`` with its standard output captured, then printed."""
    import contextlib

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    print(out.getvalue(), end='', flush=True)
    return result, out.getvalue()


def timed_run_evaluation():
    """Wrap bin.eval_3d.run_evaluation_3d to record its wall seconds: the
    window in which the loader, the uploads, the device and the host-side
    metrics share one thread. Returns (the list the times go to, undo)."""
    from margipose_tpu_torch.bin import eval_3d

    real, seconds = eval_3d.run_evaluation_3d, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return result

    eval_3d.run_evaluation_3d = timed
    return seconds, lambda: setattr(eval_3d, 'run_evaluation_3d', real)


def dataset_eval_phase(name, argv, examples, headings):
    """bin.eval_3d on ``argv`` (a real dataset's fake corpus): the forward
    kernel once a batch (once an example with --multicrop), ``headings``
    printed, finite metrics; device ms per batch and the host's share of the
    evaluation's wall window."""
    from margipose_tpu_torch.bin import eval_3d

    seconds, undo = timed_run_evaluation()
    counters = reset_counts()
    try:
        (rows, stats), printed = capture_stdout(eval_3d.main, argv)
    finally:
        undo()
    launches = read_counts(counters)
    expected = {'dsnt_jsd_fwd': stats['batches'], 'dsnt_jsd_bwd': 0}
    phase(name, f'kernel launches {launches}, expected {expected}')
    missing = [h for h in headings if h not in printed]
    finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
    if launches != expected or not stats['batches'] or missing:
        raise AssertionError(f'{name} launched {launches}, expected {expected}; missing output '
                             f'{missing}')
    if not (finite and math.isfinite(stats['mean_loss']) and len(rows['mpjpe']) == examples):
        raise AssertionError(f'{name} gave non-finite metrics or loss, or lost examples')
    ms = [t * 1e3 for t in stats['batch_seconds']]
    window_ms = seconds[0] * 1e3
    phase(name, f'device ms per batch: {", ".join(f"{m:.3f}" for m in ms)}; evaluation window '
                f'{window_ms:.3f} ms (host clock), device busy {sum(ms):.3f} ms, host\'s share '
                f'{1 - sum(ms) / window_ms:.1%}; mean loss {stats["mean_loss"]}; overall '
                f'{eval_3d.overall_metrics(rows)}')
    return launches


def mpi3d_train_phase():
    """bin.train_3d with the mpi3d preset (mpi3d-trainval + mpii-trainval,
    augmented, compositing from resources/) at batch 32, float32: both
    kernels once a step, every batch mixing 3D and 2D examples."""
    from margipose_tpu_torch.bin import train_3d
    from margipose_tpu_torch.data.mpi_inf_3dhp import _resource_files

    for kind, pattern in (('backgrounds', 'backgrounds/*.jpg'), ('textures', 'textures/*.png')):
        if not _resource_files(kind, pattern):
            raise AssertionError(f'no {kind} under {os.environ["MARGIPOSE_RESOURCES_DIR"]}: '
                                 f'compositing would do nothing')
    out_dir = os.path.join(WORK, 'mpi3d_train')
    shutil.rmtree(out_dir, ignore_errors=True)
    real_prefetch, seen = train_3d.device_prefetch, []

    def recording(loader, *args, **kwargs):
        for batch, device_batch in real_prefetch(loader, *args, **kwargs):
            seen.append(sorted({int(v) for v in batch['valid_depth']}))
            yield batch, device_batch

    train_3d.device_prefetch = recording
    counters = reset_counts()
    try:
        result = train_3d.main(['with', 'margipose_model', 'mpi3d', 'epochs=1', 'batch_size=32',
                                f'train_examples={32 * MPI3D_TRAIN_STEPS}', 'use_aug=True',
                                'metrics_every=1', 'seed=11', "precision='float32'",
                                "ship='float32'", f'out_dir={out_dir}', 'experiment_id=mpi3d'])
    finally:
        train_3d.device_prefetch = real_prefetch
    launches = read_counts(counters)
    steps = MPI3D_TRAIN_STEPS
    expected = {'dsnt_jsd_fwd': steps, 'dsnt_jsd_bwd': steps}
    phase('mpi3d train', f'kernel launches {launches}, expected {expected}; valid_depth values '
                         f'per batch {seen}')
    ckpt = os.path.join(out_dir, 'mpi3d', 'model-latest')
    if launches != expected or result['step'] != steps or seen != [[0, 1]] * steps:
        raise AssertionError(f'mpi3d train launched {launches} in {result["step"]} steps with '
                             f'valid_depth {seen}, expected {expected} in {steps}, each {{0, 1}}')
    if not (math.isfinite(result['train_loss']) and os.path.isdir(ckpt)):
        raise AssertionError(f'mpi3d train: loss {result["train_loss"]}, model-latest written '
                             f'{os.path.isdir(ckpt)}')
    ms = [t * 1e3 for t in result['step_seconds']]
    phase('mpi3d train', f'train loss {result["train_loss"]:.6f}; model-latest written; device ms '
                         f'per step of 32: first {ms[0]:.3f} (cuDNN\'s algorithm search), then '
                         f'{", ".join(f"{m:.3f}" for m in ms[1:])}; data_load_time '
                         f'{result["data_load_time"]:.4f} s a step')
    return launches


def datasets_phase(model, ckpt):
    """Phase 18: the real datasets. The kernels on the mixed recipe's rows
    ran in the kernel phases and the cuDNN policies before the main path;
    here the mixed-batch train parity, then, where h5py is installed (the processed layouts are
    HDF5), the mpi3d-test eval gate with no --dataset, --multicrop, the
    h36m-test eval and the mpi3d train preset on fake corpora. Returns the
    launches by path (None for a path that did not run)."""
    import importlib.util

    t_phase = time.perf_counter()
    mixed_train_parity_phase(model)
    paths = ('mpi3d_eval', 'mpi3d_multicrop', 'h36m_eval', 'mpi3d_train')
    if importlib.util.find_spec('h5py') is None:
        phase('datasets', 'h5py is not installed here, so the HDF5 dataset sub-phases (the '
                          'mpi3d-test eval gate and its --multicrop, the h36m-test eval, the '
                          'mpi3d train preset) did not run: the processed MPI-INF-3DHP, '
                          'Human3.6M and MPII layouts are HDF5 files')
        phase('datasets', f'phase 18 took {time.perf_counter() - t_phase:.1f} s')
        return dict.fromkeys(paths)
    from margipose_tpu_torch.data.fake_mpi3d import generate_fake_mpi3d
    from margipose_tpu_torch.data.fakes import generate_fake_h36m, generate_fake_mpii

    base = os.path.join(WORK, 'datasets')
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'test'), seqs=((1, 1), (2, 1)),
                        camera_ids=(0,), n_frames=24, with_activities=True)
    generate_fake_mpi3d(os.path.join(base, 'few', 'mpi3d', 'test'), seqs=((1, 1), (2, 1)),
                        camera_ids=(0,), n_frames=MULTICROP_EXAMPLES // 2, with_activities=True)
    generate_fake_h36m(os.path.join(base, 'h36m'), subjects=(9,), camera_ids=(1, 2), n_frames=8)
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'train'), seqs=((1, 1),), camera_ids=(0,),
                        n_frames=24, seed=1)
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'val'), seqs=((2, 2),), camera_ids=(0,),
                        n_frames=24, seed=2)
    generate_fake_mpii(os.path.join(base, 'mpii'), n_train=32, n_val=16)
    phase('datasets', f'fake corpora written in {time.perf_counter() - t0:.1f} s under {base}')
    os.environ['MARGIPOSE_BASE_DATA_DIR'] = base
    os.environ['MARGIPOSE_RESOURCES_DIR'] = os.path.join(ROOT, 'resources')
    tables = ('### By sequence', '### By activity', '### Overall', 'TS1/Seq1', 'TS2/Seq1')
    by_path = {'mpi3d_eval': dataset_eval_phase(
        'mpi3d eval', ['--model', ckpt, '--batch-size', '32', '--precision', 'float32',
                       '--device', 'cuda'], 48, tables)}
    os.environ['MARGIPOSE_BASE_DATA_DIR'] = os.path.join(base, 'few')
    by_path['mpi3d_multicrop'] = dataset_eval_phase(
        'mpi3d multicrop', ['--model', ckpt, '--multicrop', '--precision', 'float32',
                            '--device', 'cuda'], MULTICROP_EXAMPLES, tables)
    os.environ['MARGIPOSE_BASE_DATA_DIR'] = base
    by_path['h36m_eval'] = dataset_eval_phase(
        'h36m eval', ['--model', ckpt, '--dataset', 'h36m-test', '--batch-size', '8',
                      '--precision', 'float32', '--device', 'cuda'], 16,
        ('Use ground truth root joint depth? True', 'Number of joints in evaluation: 17'))
    by_path['mpi3d_train'] = mpi3d_train_phase()
    phase('datasets', f'phase 18 took {time.perf_counter() - t_phase:.1f} s')
    return by_path


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card',
              file=sys.stderr)
        return 1
    kind, _ = device_phase()
    build_phase()
    host_ops_phase()
    kernels = [kernel_phase(), backward_kernel_phase()]
    sweep_phase(kernels)
    torch.cuda.synchronize()
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode

    set_float32_parity_mode()
    model = flagship('cuda')
    cudnn_policy_phase(model)
    by_path = {}
    by_path['eval'], ckpt = main_path_phase(model)
    trace_phase(model)
    parity_phase(model)
    by_path['eval_bf16'] = bf16_eval_phase(model, ckpt)
    by_path['multicrop'] = multicrop_phase(ckpt)
    by_path['train'] = train_path_phase()
    train_trace_phase(model)
    train_parity_phase(model)
    by_path['train_bf16'] = bf16_train_phase()
    train_trace_phase(model, 'bfloat16', 'bf16 train trace')
    by_path['infer'] = infer_phase(model)
    by_path['serve'] = serve_phase(ckpt)
    by_path.update(stems_phase())
    by_path.update(chatterbox_phase())
    by_path.update(datasets_phase(model, ckpt))
    for k in kernels:
        # launches: the float32 train path's, which runs both kernels
        k['launches'] = by_path['train'][k['name']]
        k['launches_by_path'] = {path: None if counts is None else counts[k['name']]
                                 for path, counts in by_path.items()}
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
