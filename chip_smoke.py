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
  8. train trace   torch.profiler over one eager train step at batch 32 (the
                   CUDA graph's body), with the step's launches and device
                   idle time under each of its spans
                   (margipose_tpu_torch.tracing); after phase 11, the train
                   graph: 6 steps replayed from the step's CUDA graph
                   against 6 eager ones in float32 and bf16, held to the
                   train cell's loss and update limits, with the step's
                   eager / capture / replay counts, and a replayed step's
                   device time and idle share beside an eager one's;
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
 19. device aug    bin.train_3d with device_aug=True at batch 32, full
                   frames (synthetic-512's 512 px) and crop-ship onto a
                   384 px canvas (device_aug_canvas=384), each in float32
                   and bf16, 3 steps and a validation batch: both kernels
                   once a step, raw uint8 frames uploaded in place of the
                   input, bytes a batch against the host-augmented uint8
                   upload; one augmented batch of 32 card against CPU (both
                   canvases, 1e-5 in pixel units); a device-augmented train
                   step at batch 2 card against CPU (phase 9's rules);
 20. distributed   bin.train_3d under `torch.distributed.run --standalone
                   --nproc_per_node 1 chip_smoke.py --ddp-worker DIR`: NCCL
                   at world size 1, so DistributedDataParallel and the
                   global batch-norm and loss all-reduces run (counted);
                   both kernels once a step; the worker's train step at
                   batch 2 against the card's non-distributed step (phase
                   9's rules) and a traced DDP step of 32 (printed as
                   [ddp train trace]); bin.eval_3d --num-devices 1 against
                   plain eval, and --num-devices 2, which must exit with the JAX
                   bin's message on a one-card machine.
 21. cli           the margipose command (margipose_tpu_torch.bin.main) on
                   the card: hyperparams, the LR range test, on the
                   full-width flagship in float32 at batch 32, 8 iterations
                   (both kernels once an iteration, lrs geometric from
                   lr_min, losses finite, lr_curve.csv written, ms per
                   iteration by CUDA events); the sweep card against CPU (2
                   iterations at batch 2: losses rtol 1e-3, phase 9's L2
                   rule on each iteration from a common state; the
                   compounded shares, card and a 1-thread CPU run against
                   the CPU, printed); eval through the dispatcher on phase 7's
                   model-latest against bin.eval_3d.main; export_model -f
                   native / torch (reload strict, equal outputs) and -f
                   export (torch.export, reloaded on the card, within 1e-4
                   of the eager forward, both timed at batch 1); gui on two
                   synthetic examples of the main path's checkpoint (the
                   forward card against CPU, the HTML report where
                   matplotlib is installed; phase 7's checkpoint's gap
                   printed);
                   calc_dataloader_stats on synthetic-64; bench_loader where
                   h5py is installed.
 22. tensor parallel
                   the hybrid ('data', 'model') mesh (parallel/mesh.py) on
                   the full-width flagship: `torch.distributed.run
                   --nproc_per_node 1 chip_smoke.py --tp-worker DIR 1 1 nccl`
                   (mesh (1, 1), nothing sharded, no DDP) and two processes
                   on cuda:0 over gloo (mesh (1, 2): 346 convolutions split
                   on output channels; NCCL refuses two ranks on one card).
                   Each: one eval batch and one train step at batch 2, both
                   kernels counted (2 and 1 in every process), all-reduces
                   and all-gathers counted, every process's gathered weights
                   equal bit for bit, the step against the card's plain step
                   (phase 9's rules), the eval batch against plain eval.
 23. soak          the soaks (margipose_tpu_torch.soak) through the train
                   bin in child processes: the full-schedule recipe
                   (MargiPose 2 stages, resnet18, 128 px, batch 8, lr 0.2,
                   device aug crop-ship onto 192 px, a checkpoint an epoch)
                   on synthetic data, cut to 12 epochs of 8 steps,
                   SIGKILLed once epoch 6 is saved and resumed; Chatterbox
                   for 2 epochs of 20 steps at batch 16; each verified in
                   this process (soak/verify.py: the 1cycle trajectory and
                   shape, the optimiser's last applied lr and count, the
                   restore at epoch T, a strict load and bin.eval_3d within
                   1e-6 of the training process's eval of its live state),
                   with both kernels once a step, the step times and save
                   times printed; three planted faults (a resume one update
                   short, BN statistics reset, an epoch's records removed)
                   must each fail the verifier.
 24. integral      (run after phase 17) the volumetric soft-argmax kernels
                   (csrc/softargmax3d.cu) against their plain versions in
                   float32 and bf16 at the integral model's shape (544
                   volumes of 64^3) and two small ones, timed in a CUDA
                   graph against their bytes bound; the integral model
                   (ResNet-50, D = 64) through bin.train_3d in bf16 (its
                   kernels counted from a device trace, no loss-head
                   kernel), bin.eval_3d, infer_single and the serve runner;
                   its bf16 train step replayed from a CUDA graph against
                   eager steps, and a replayed step by kernel group.
 25. batch norm    the train-mode batch-norm kernels (csrc/batch_norm.cu)
                   against their plain version (torch's batch norm and the
                   running-variance fix-up) in float32 and bf16 at the train
                   cells' shapes and three single-value layouts, the same
                   bits on a second run, timed in a CUDA graph against their
                   bytes bound and torch's batch norm; graphed train steps
                   bit-equal to eager ones (flagship bf16 and float32,
                   integral, Chatterbox) with each batch norm's two kernels
                   once a step and no ATen train-mode batch-norm kernel (the
                   bin train paths of phases 7, 12-13, 15, 19 and 24 check
                   the same in their device traces).
The float32 phases (4-9 and the float32 parts of 16-17) pass precision
float32 and float32 input upload explicitly. Each path's kernel launches are
counted from 0 around it. A train step on one card replays a CUDA graph, which
runs both loss-head kernels with no host launch: the in-process train paths
run under torch.profiler and report the kernels their device trace saw run,
each checked against one a train step (and the forward once a validation
batch) and the wrappers' host launches against one an eager or capturing
step; the soak, whose runs are too long to trace, checks the host launches
against the step's counts. Then one JSON line of per-kernel numbers, and last
the result line {"ok": true, "device": {...}}. Without a CUDA device it
exits 1 and prints no result. The flagship's train paths run 4 steps; the
later paths run 2-3, and phase 23 overlaps two of its runs, to keep the
script near 10 minutes.

    python3 chip_smoke.py --multi-gpu   (several cards)

phase 20 across every card, phase 22 on the meshes (n/2, 2) and (1, n),
and on four cards or more the launcher's two-node command rehearsed as two
torchrun agents of n/2 workers (deploy/rehearsal.py), killed after the
first checkpoint and resumed across both, held to one agent's step.

    python3 chip_smoke.py --soak

the soaks at full length: the 150-epoch schedule killed at epoch 75 and
during epoch 110's save, Chatterbox for 6 epochs, each verified; on the
fake corpus as well where h5py is installed.
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

from margipose_tpu_torch.ops import launch_counts, zero_launch_counts
from margipose_tpu_torch.ops._build import KERNELS

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
    (6, 8, 17, 16, 16, 1.0, 0),    # the full-schedule soak's: 2 stages at 128 px, batch 8
    (6, 4, 17, 16, 16, 1.0, 0),    # its eval's, at batch 4
    (3, 16, 17, 32, 32, 1.0, 0),   # Chatterbox's soak at batch 16
    (3, 4, 17, 32, 32, 1.0, 0),    # its eval's, at batch 4
    (12, 8, 17, 32, 32, 1.0, 0),   # --multi-gpu's two-node rehearsal: 8 rows a process
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
DEVICE_AUG_STEPS = 3       # each on-device augmentation train path at batch 32
CROP_CANVAS = 384          # crop-ship canvas of the device_aug_canvas paths
DDP_STEPS = 3              # the train bin's steps under the NCCL process group
HYPERPARAM_ITERS = 8       # the LR range test's iterations at batch 32
TP_TRACE_ROWS = 32         # global rows of phase 22's traced hybrid-mesh step
SOAK_EPOCHS = 12           # phase 23's full schedule: 12 epochs of 8 steps at batch 8
SOAK_KILL_AT = 6           # ... SIGKILLed once this epoch's checkpoint is saved
SOAK_CHATTERBOX_EPOCHS = 2  # phase 23's Chatterbox soak: epochs of 20 steps at batch 16
REHEARSAL_STEPS = 4        # --multi-gpu's two-node rehearsal: steps of 32 global rows
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
    multicrop eval's 10 crops, the soaks' train and eval batches, the
    two-node rehearsal's, one group, the generic layout, H*W % 4 != 0
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


# the heads' kernels by their entry points (ops/_build.KERNELS, which knows
# the names a device trace gives them): the loss head's (MargiPose,
# Chatterbox), the integral model's soft-argmax and train-mode batch norm
LOSS_HEAD_KERNELS = ('dsnt_jsd_fwd', 'dsnt_jsd_bwd')
SOFTARGMAX3D_KERNELS = ('softargmax3d_fwd', 'softargmax3d_bwd')
BATCH_NORM_KERNELS = ('batch_norm_train_fwd', 'batch_norm_train_bwd',
                      'batch_norm_train_nhwc_fwd', 'batch_norm_train_nhwc_bwd')


# the train-mode batch-norm kernels by the names a device trace gives them:
# the port's NCHW pair (float32 steps) and channels-last pair (the bf16 step
# on one card), once a batch norm each way, ATen's, which the port no longer
# runs, and cuDNN's layout transposes, which a channels-last step runs none of
BATCH_NORM_WORDS = {
    'fwd': KERNELS['batch_norm_train_fwd'].traced,
    'bwd': KERNELS['batch_norm_train_bwd'].traced,
    'nhwc_fwd': KERNELS['batch_norm_train_nhwc_fwd'].traced,
    'nhwc_bwd': KERNELS['batch_norm_train_nhwc_bwd'].traced,
    'aten': ('batch_norm_collect_statistics', 'batch_norm_backward'),
    'transpose': ('nchwToNhwc', 'nhwcToNchw'),
}
BATCH_NORM_RAN = {}  # the batch-norm kernels of on_card's last trace, by BATCH_NORM_WORDS


def reset_counts(names=LOSS_HEAD_KERNELS):
    """The named kernels' launch counts set to 0, just before a path runs;
    returns the names, for read_counts."""
    zero_launch_counts(*names)
    return names


def read_counts(names):
    return launch_counts(*names)


def on_card(fn, kernels=LOSS_HEAD_KERNELS):
    """``fn()`` under torch.profiler (device activity alone), the wrappers'
    counters of ``kernels`` zeroed just before it: (its result, the wrappers'
    host launches, the kernels the device trace saw run). A train step
    replayed from its CUDA graph runs its kernels with no host launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counters = reset_counts(kernels)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a few ms of device spin on either side of fn's kernels, so that
        # none lies at the edges of the trace's window
        torch.cuda._sleep(10_000_000)
        out = fn()
        torch.cuda._sleep(10_000_000)
        torch.cuda.synchronize()
    host = read_counts(counters)
    ran = dict.fromkeys(kernels, 0)
    BATCH_NORM_RAN.clear()
    BATCH_NORM_RAN.update(dict.fromkeys(BATCH_NORM_WORDS, 0))
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            for name in kernels:
                ran[name] += any(w in e.name() for w in KERNELS[name].traced)
            for name, words in BATCH_NORM_WORDS.items():
                BATCH_NORM_RAN[name] += any(w in e.name() for w in words)
    return out, host, ran


def batch_norm_layers(state_dict):
    """The model's batch norms: one ``num_batches_tracked`` each."""
    return sum(k.endswith('num_batches_tracked') for k in state_dict)


def batch_norm_expected(layers, steps, channels_last):
    """The kernels of BATCH_NORM_WORDS a path runs: each of ``layers`` batch
    norms once each way in each of ``steps`` train steps, through the
    channels-last pair where the step runs channels-last (bf16 on one card)
    and the NCHW pair elsewhere; never ATen's. cuDNN's transposes are
    reported, not held: its timed search (the bins' policy) may pick an
    algorithm that transposes a small convolution of a channels-last step."""
    n = layers * steps
    pair = dict.fromkeys(('nhwc_fwd', 'nhwc_bwd') if channels_last else ('fwd', 'bwd'), n)
    return {'fwd': 0, 'bwd': 0, 'nhwc_fwd': 0, 'nhwc_bwd': 0, **pair, 'aten': 0}


def check_batch_norm_ran(name, layers, steps, channels_last):
    """On on_card's last trace: each of ``layers`` batch norms ran the
    port's forward and backward kernels for the step's layout once in each
    of ``steps`` train steps, and no ATen train-mode batch-norm kernel
    ran."""
    want = batch_norm_expected(layers, steps, channels_last)
    ran = {k: v for k, v in BATCH_NORM_RAN.items() if k != 'transpose'}
    phase(name, f'train-mode batch norm on the card {dict(BATCH_NORM_RAN)}, expected {want} '
                f'({layers} batch norms x {steps} steps, '
                f'{"channels-last" if channels_last else "NCHW"})')
    if ran != want:
        raise AssertionError(f'{name}: batch-norm kernels ran {dict(BATCH_NORM_RAN)}, '
                             f'expected {want}')


def loss_head_expected(counts, steps, val_batches):
    """A train path's loss-head kernels as (run on the card, launched by the
    host): on the card each once a train step and the forward once more a
    validation batch; from the host once an eager or capturing step
    (``counts``: the train step's ``step_counts``) and once a validation
    batch."""
    host = counts['eager_steps'] + counts['captures']
    return ({'dsnt_jsd_fwd': steps + val_batches, 'dsnt_jsd_bwd': steps},
            {'dsnt_jsd_fwd': host + val_batches, 'dsnt_jsd_bwd': host})


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
    size = desc['settings'].get('input_size', 256)
    randomize_batch_norm(model, torch.randn(8, 3, size, size, generator=g).to(device), g)
    return model


def flagship(device):
    """The flagship from seed 0, BN statistics calibrated and perturbed, the
    columns' last blocks scaled down (``seeded_model``)."""
    from margipose_tpu_torch.models import Default_MargiPose_Desc

    return seeded_model(Default_MargiPose_Desc, device)


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
    busy ms, the unprofiled window's ms, ``span_breakdown``'s launches and
    idle ms under each program span, {} where none ran). The profiler adds
    host time to every launch, so only the unprofiled window says how long
    the device waits for the host. The events are empty where the profiler saw no
    device activity. Ranges the host names (``record_function``:
    ``nccl:all_reduce``, ``DistributedDataParallel.forward``) also carry
    device time, that of the kernels inside them: they are left out, so no
    kernel is counted twice."""
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
    averages = prof.key_averages()
    host_ranges = {e.key for e in averages if e.device_type == DeviceType.CPU}
    events = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in host_ranges]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return (events, busy_ms, start.elapsed_time(end),
            span_breakdown(prof.profiler.kineto_results.events()))


def span_breakdown(raw):
    """The profiled call's kernel launches and device idle ms under each
    program span (``margipose_tpu_torch.tracing``), from the profiler's raw
    events: {span: [launches, idle ms]}, {} where no span ran, ``(none)``
    for launches outside every span. A launch counts under the innermost span whose interval
    holds its start (the autograd engine's thread launches while the main
    thread is in ``train.backward``); a stretch inside the outermost span
    with no device activity counts under the innermost span at its middle."""
    from torch.autograd import DeviceType

    from margipose_tpu_torch import tracing

    spans, launches, device, host_names = [], [], [], set()
    for e in raw:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((start, end, e.name()))
            continue
        host_names.add(e.name())
        if e.name() in tracing.SPANS:
            spans.append((start, end, e.name()))
        elif e.name().startswith(tracing.LAUNCHES):
            launches.append(start)
    if not spans:
        return {}

    def innermost(t):
        inside = [s for s in spans if s[0] <= t < s[1]]
        return max(inside, key=lambda s: (s[0], -s[1]))[2] if inside else '(none)'

    out = {name: [0, 0.0] for name in tracing.SPANS + ('(none)',)}
    for t in launches:
        out[innermost(t)][0] += 1
    lo, hi = min(s[0] for s in spans), max(s[1] for s in spans)
    cursor = lo
    for s, e, _ in sorted(d for d in device if d[2] not in host_names):
        if s > cursor and cursor < hi:
            gap_end = min(s, hi)
            out[innermost((cursor + gap_end) // 2)][1] += (gap_end - cursor) / 1e6
        cursor = max(cursor, e)
    if hi > cursor:
        out[innermost((cursor + hi) // 2)][1] += (hi - cursor) / 1e6
    return out


def kernel_ms(events, words):
    return sum(e.self_device_time_total for e in events
               if any(w in e.key.lower() for w in words)) / 1e3


# cuDNN's convolution kernels: implicit GEMM, FFT (r2c, pointwise complex
# product, c2r), dgrad (also the transposed convolution's forward) and wgrad
CONV_WORDS = ('conv', 'gemm', 'xmma', 'fft', 'complex', 'dgrad', 'wgrad', 'fprop')
FFT_WORDS = ('fft', 'complex')
TP_TRACE_GROUPS = [('convolutions', CONV_WORDS), ('batch norm', ('batch_norm', 'bn_')),
                   ('NCCL collectives', ('nccl',)), ('copies and casts', ('copy',)),
                   ('concatenation', ('catarray',)), ('dsnt_jsd head', ('dsnt_jsd',))]
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

    events, busy, window, _ = profiled(step)
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
    result, host, launches = on_card(lambda: train_3d.main(
        ['with', 'margipose_model', 'synthetic', 'epochs=1', 'batch_size=32',
         f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']", 'val_examples=32',
         'metrics_every=1', f'seed={seed}', "precision='float32'", "ship='float32'",
         f'out_dir={out_dir}', 'experiment_id=flagship']))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected, expected_host = loss_head_expected(result['step_counts'], steps, val_batches)
    phase('train', f'kernels run on the card {launches}, expected {expected} (one grouped '
                   f'kernel each way a step for 3 planes x 4 stages; {steps} train steps, '
                   f'{val_batches} validation batch); host launches {host}, expected '
                   f'{expected_host} ({result["step_counts"]})')
    if launches != expected or host != expected_host or result['step'] != steps:
        raise AssertionError(f'train path ran {launches} and launched {host} in '
                             f'{result["step"]} steps, expected {expected} and {expected_host} '
                             f'in {steps}')

    ckpt_dir = os.path.join(out_dir, 'flagship', 'model-latest')
    saved = checkpoint.load_payload(ckpt_dir)['model']
    check_batch_norm_ran('train', batch_norm_layers(saved), steps, channels_last=False)
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
                   f'a step; peak memory {peak_gib:.2f} GiB (max_memory_allocated); the run '
                   f'under the profiler')

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
    torch.profiler over the port's eager train step (the graph's body) with
    its spans on, kernels grouped by name, and the step's launches and
    device idle time under each phase (``train.forward``, ``train.loss``,
    ``train.backward``, ``train.update`` and the step's own). Tracing is on
    for all of ``profiled``'s calls: five spans cost the unprofiled window a
    few us."""
    from margipose_tpu_torch import tracing
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, eager, make_train_step

    model = copy.deepcopy(model)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, max_iters=100))
    step = make_train_step('jsd', precision)
    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=5).items()}
    step(state, batch)  # cuDNN's algorithm search for the train shapes

    tracing.enable()
    try:
        events, busy, window, by_span = profiled(lambda: eager(step, state, batch))
    finally:
        tracing.disable()
        tracing.take()
    report_trace(name, f'one eager train step of 32, {precision}', events, busy, window,
                 TRAIN_GROUPS)
    if events:
        phase(name, 'under each span (launches, device idle ms; the profiler slows the host): '
                    + '; '.join(f'{span} {n} launches, idle {ms:.3f} ms'
                                for span, (n, ms) in by_span.items()))


TRAIN_GROUPS = [('convolutions', CONV_WORDS), ('batch norm', ('batch_norm', 'bn_')),
                ('dsnt_jsd_fwd', ('dsnt_jsd_fwd',)), ('dsnt_jsd_bwd', ('dsnt_jsd_bwd',)),
                ('softmax', ('softmax',)), ('optimiser', ('multi_tensor', 'foreach', 'sgd')),
                ('of which FFT', FFT_WORDS), ('copies and casts', ('copy',))]


# graphed against eager flagship steps at batch 32 over 6 steps: each step
# function makes its own cuDNN timed search, which may pick other float32
# algorithms, and lr 1 carries their rounding into every weight (float32 read
# 4.1e-4 and 7.4e-3 on an H100, bf16 0). The limits are those the train cell
# holds a bf16 run to against its float32 reference.
GRAPH_LOSS_GAP = 1e-3
GRAPH_UPDATE_GAP = 0.07


def median_leaf_gap(got, want):
    """(median, largest) over the parameters of the gap between two norms of
    their change, ``got`` against ``want`` (dicts by name), each relative to
    the larger of ``want``'s and the median norm; parameters that changed by
    under a thousandth of the median are left out."""
    floor = 1e-3 * float(np.median(list(want.values())))
    kept = [k for k, v in want.items() if v >= floor]
    median = float(np.median([want[k] for k in kept]))
    gaps = np.array([abs(got[k] - want[k]) / max(want[k], median) for k in kept])
    return float(np.median(gaps)), float(gaps.max())


def train_graph_phase(model, precision='float32', name='train graph'):
    """The flagship's train step at batch 32 replayed from its CUDA graph
    against the same steps run eagerly, from one set of weights over 6
    seeded batches: the losses' largest relative gap and the median leaf's
    gap of the parameters' change, within GRAPH_LOSS_GAP and
    GRAPH_UPDATE_GAP; the step function's eager / capture / replay counts;
    one replayed step's device time and idle share beside an eager step's,
    and the kernels whose launch counts differ between the two."""
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, eager, make_train_step, step_counts

    states, steps, losses = [], [], []
    for _ in range(2):
        m = copy.deepcopy(model)
        states.append(TrainState(m, make_optimiser('1cycle', m.parameters(), 1.0, max_iters=100)))
        steps.append(make_train_step('jsd', precision))
        losses.append([])
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    for seed in range(6):
        batch = {k: v.cuda() for k, v in flagship_batch(32, seed=40 + seed).items()}
        losses[0].append(steps[0](states[0], batch)['loss'])
        losses[1].append(eager(steps[1], states[1], batch)['loss'])
    got, want = (torch.stack(x).double().cpu().numpy() for x in losses)
    loss_gap = float(np.max(np.abs(got - want) / np.abs(want)))
    change = [{k: float((p.detach() - start[k]).norm()) for k, p in s.model.named_parameters()}
              for s in states]
    update_gap, worst = median_leaf_gap(*change)
    counts = step_counts(steps[0])
    phase(name, f'{precision}: graphed vs eager over 6 steps: loss gap {loss_gap:.3e} (limit '
                f'{GRAPH_LOSS_GAP}), update gap median {update_gap:.3e} (limit '
                f'{GRAPH_UPDATE_GAP}), worst leaf {worst:.3e}; counts {counts}')
    if not (loss_gap <= GRAPH_LOSS_GAP and update_gap <= GRAPH_UPDATE_GAP
            and counts == {'eager_steps': 1, 'captures': 1, 'replays': 4}):
        raise AssertionError(f'{name}: the graphed step left the eager one or did not replay')

    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=5).items()}
    replayed = profiled(lambda: steps[0](states[0], batch))
    eagerly = profiled(lambda: eager(steps[1], states[1], batch))
    report_trace(name, f'one replayed train step of 32, {precision}', *replayed[:3],
                 TRAIN_GROUPS)
    phase(name, f'eager step: window {eagerly[2]:.3f} ms, replayed {replayed[2]:.3f} ms; counts '
                f'{step_counts(steps[0])}')
    if replayed[0] and eagerly[0]:
        by_name = [{e.key: e.count for e in r[0]} for r in (replayed, eagerly)]
        differ = sorted((by_name[0].get(k, 0) - by_name[1].get(k, 0), k)
                        for k in set(by_name[0]) | set(by_name[1])
                        if by_name[0].get(k, 0) != by_name[1].get(k, 0))
        phase(name, f'launches replayed {sum(by_name[0].values())}, eager '
                    f'{sum(by_name[1].values())}; differing kernels (replayed - eager): '
                    + '; '.join(f'{d:+d} {k[:90]}' for d, k in (
                        differ if len(differ) <= 12 else differ[:6] + differ[-6:])))


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
    result, host, launches = on_card(lambda: train_3d.main(
        ['with', 'margipose_model', 'synthetic', 'epochs=1', 'batch_size=32',
         f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']", 'val_examples=32',
         'metrics_every=1', 'seed=7', "precision='bfloat16'", "ship='uint8'",
         f'out_dir={out_dir}', 'experiment_id=flagship']))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected, expected_host = loss_head_expected(result['step_counts'], steps, val_batches)
    phase('bf16 train', f'kernels run on the card {launches}, expected {expected}; host '
                        f'launches {host}, expected {expected_host} ({result["step_counts"]})')
    if launches != expected or host != expected_host or result['step'] != steps:
        raise AssertionError(f'bf16 train path ran {launches} and launched {host} in '
                             f'{result["step"]} steps, expected {expected} and '
                             f'{expected_host} in {steps}')
    payload = checkpoint.load_payload(os.path.join(out_dir, 'flagship', 'model-latest'))
    check_batch_norm_ran('bf16 train', batch_norm_layers(payload['model']), steps,
                         channels_last=True)
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
    validation batch: both kernels run on the card once a step (the forward
    also once for the validation batch), launched by the host once an eager
    or capturing step; the port's batch-norm kernels once a batch norm each
    way a step. Returns (the kernels run, result, checkpoint directory)."""
    from margipose_tpu_torch.bin import train_3d
    from margipose_tpu_torch.train import checkpoint

    out_dir = os.path.join(WORK, experiment_id)
    shutil.rmtree(out_dir, ignore_errors=True)
    result, host, launches = on_card(lambda: train_3d.main(
        ['with', *words, 'epochs=1', 'batch_size=32', f'train_examples={32 * steps}',
         "val_datasets=['synthetic-32@1']", 'val_examples=32', 'metrics_every=1', 'seed=9',
         f'out_dir={out_dir}', f'experiment_id={experiment_id}']))
    expected, expected_host = loss_head_expected(result['step_counts'], steps, 1)
    phase(name, f'kernels run on the card {launches}, expected {expected}; host launches '
                f'{host}, expected {expected_host} ({result["step_counts"]})')
    with open(os.path.join(out_dir, experiment_id, 'metrics.jsonl')) as f:
        val_loss = json.loads(f.readline())['val_loss']
    if launches != expected or host != expected_host or result['step'] != steps:
        raise AssertionError(f'{name} ran {launches} and launched {host} in {result["step"]} '
                             f'steps, expected {expected} and {expected_host} in {steps}')
    ckpt_dir = os.path.join(out_dir, experiment_id, 'model-latest')
    check_batch_norm_ran(name, batch_norm_layers(checkpoint.load_payload(ckpt_dir)['model']),
                         steps, channels_last="precision='bfloat16'" in words)
    if not (math.isfinite(result['train_loss']) and math.isfinite(val_loss)):
        raise AssertionError(f'{name}: train loss {result["train_loss"]}, val loss {val_loss}')
    ms = [s * 1e3 for s in result['step_seconds']]
    phase(name, f'train loss {result["train_loss"]:.6f}, val loss {val_loss:.6f}; device ms per '
                f'step of 32: first {ms[0]:.3f} (cuDNN\'s algorithm search), then '
                f'{", ".join(f"{m:.3f}" for m in ms[1:])}; data_load_time '
                f'{result["data_load_time"]:.4f} s a step')
    return launches, result, ckpt_dir


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


def step_parity(name, what, model, batch_for, distributed=None):
    """One train step at batch 2 on the card against the reference step,
    under train_parity_phase's rules: ``batch_for(device)`` gives the batch;
    the reference is the CPU's step, or ``distributed`` (loss, state_dict)
    checked against the card's own non-distributed step."""
    initial = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
    if distributed is None:
        loss_gpu, gpu = train_step_state(model, 'cuda', batch_for('cuda'))
        loss_ref, ref = train_step_state(model, 'cpu', batch_for('cpu'))
    else:
        loss_gpu, gpu = distributed
        loss_ref, ref = train_step_state(model, 'cuda', batch_for('cuda'))
    loss_rel = abs(loss_gpu - loss_ref) / abs(loss_ref)
    share, row_share = worst_update_share(gpu, ref, initial), worst_row_share(gpu, ref, initial)
    worst_buffer = max(((gpu[k] - ref[k]).abs() / (1e-5 + 1e-4 * ref[k].abs())).max().item()
                       for k in ref if 'running_' in k)
    finite = all(torch.isfinite(v).all() for v in gpu.values()) and math.isfinite(loss_gpu)
    phase(name, f'{what}: loss {loss_gpu:.6f} vs {loss_ref:.6f}, rel err {loss_rel:.3g} (rtol '
                f'1e-3); worst parameter tensor at {share[0]:.4f} of 10% of its update + 1e-6 RMS '
                f'({share[1]}); worst joint row at {row_share[0]:.4f} ({row_share[1]}, row '
                f'{row_share[2]}); worst BN buffer at {worst_buffer:.3g}; finite {finite}')
    if not (finite and loss_rel <= 1e-3 and share[0] <= 1 and row_share[0] <= 1
            and worst_buffer <= 1):
        raise AssertionError(f'{name}: {what} disagrees')


def mixed_train_parity_phase(model):
    """One flagship train step at batch 2 on a mixed 2D/3D batch, card
    against CPU, under train_parity_phase's rules."""
    batch = mixed_batch(seed=12)
    step_parity('datasets', 'mixed 2D/3D batch of 2 (valid_depth 1 and 0, half the 2D '
                            'example\'s joints masked, 5 targets off the map), one train step card '
                            'vs CPU', model, lambda device: batch)


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
    try:
        result, host, launches = on_card(lambda: train_3d.main(
            ['with', 'margipose_model', 'mpi3d', 'epochs=1', 'batch_size=32',
             f'train_examples={32 * MPI3D_TRAIN_STEPS}', 'use_aug=True', 'metrics_every=1',
             'seed=11', "precision='float32'", "ship='float32'", f'out_dir={out_dir}',
             'experiment_id=mpi3d']))
    finally:
        train_3d.device_prefetch = real_prefetch
    steps = MPI3D_TRAIN_STEPS
    expected, expected_host = loss_head_expected(result['step_counts'], steps, 0)
    phase('mpi3d train', f'kernels run on the card {launches}, expected {expected}; host '
                         f'launches {host}, expected {expected_host} ({result["step_counts"]}); '
                         f'valid_depth values per batch {seen}')
    ckpt = os.path.join(out_dir, 'mpi3d', 'model-latest')
    if (launches != expected or host != expected_host or result['step'] != steps
            or seen != [[0, 1]] * steps):
        raise AssertionError(f'mpi3d train ran {launches} and launched {host} in '
                             f'{result["step"]} steps with valid_depth {seen}, expected '
                             f'{expected} and {expected_host} in {steps}, each {{0, 1}}')
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


def recording_uploads(train_3d):
    """Wrap bin.train_3d.device_prefetch to record each uploaded batch's
    device fields. Returns (the list they go to, undo)."""
    real, seen = train_3d.device_prefetch, []

    def recording(loader, *args, **kwargs):
        for batch, device_batch in real(loader, *args, **kwargs):
            seen.append(sorted(device_batch))
            yield batch, device_batch

    train_3d.device_prefetch = recording
    return seen, lambda: setattr(train_3d, 'device_prefetch', real)


def bytes_uploaded(batch, ship_specs):
    """The host bytes bin.train_3d.device_prefetch hands to data.specs.to_device
    (the one host-to-device copy) for ``batch``."""
    from margipose_tpu_torch.bin import train_3d
    from margipose_tpu_torch.data import specs

    real, sizes = specs.to_device, []

    def counting(arr, device):
        sizes.append(arr.nbytes)
        return real(arr, device)

    specs.to_device = train_3d.to_device = counting
    try:
        next(train_3d.device_prefetch([batch], torch.device('cuda'), 1, ship_specs))
    finally:
        specs.to_device = train_3d.to_device = real
    return sum(sizes)


def synthetic_loader(batch, **device_aug):
    """bin.train_3d's loader over synthetic-512 (512 px frames), augmented,
    ``batch`` examples; ``device_aug`` keywords as create_train_dataloader's."""
    from margipose_tpu_torch.models import Default_MargiPose_Desc, data_specs_for_desc
    from margipose_tpu_torch.train.helpers import create_train_dataloader

    return create_train_dataloader(['synthetic-512'], data_specs_for_desc(Default_MargiPose_Desc),
                                   batch, batch, use_aug=True, num_workers=4, seed=0,
                                   **device_aug)


def aug_input(raw_batch, device):
    """The train bin's aug step on ``device`` over a raw device-aug batch:
    its batch with the augmented NCHW input in place of the raw fields."""
    from margipose_tpu_torch.bin import train_3d

    specs = raw_batch['specs']
    x = train_3d.make_aug_step(specs)(*(torch.from_numpy(np.asarray(raw_batch[k])).to(device)
                                        for k in ('raw_image', 'aug_affine', 'aug_colour')))
    return {'input': x, 'target': torch.from_numpy(np.asarray(raw_batch['target'])),
            'joint_mask': torch.from_numpy(np.asarray(raw_batch['joint_mask'])),
            'valid_depth': torch.from_numpy(np.asarray(raw_batch['valid_depth']))}


def device_aug_phase(model):
    """Phase 19: on-device augmentation. bin.train_3d with device_aug=True at
    batch 32, full frames (synthetic-512's 512 px) and crop-ship onto
    CROP_CANVAS px, each in float32 and bf16: both kernels once a step (the
    forward once more for the validation batch), the bytes each batch
    uploads against the host-augmented uint8 input's; one augmented batch of
    32, card against CPU, in pixel units; a device-augmented train step at
    batch 2, card against CPU, under the L2 rule. Returns the launches by
    path."""
    from margipose_tpu_torch.bin import train_3d
    from margipose_tpu_torch.models import Default_MargiPose_Desc, data_specs_for_desc

    t_phase = time.perf_counter()
    specs = data_specs_for_desc(Default_MargiPose_Desc).input_specs
    sizes = {'host-augmented input, uint8 (32x256x256x3)': bytes_uploaded(
        next(iter(synthetic_loader(32))), specs)}
    for canvas in (0, CROP_CANVAS):
        label = f'crop-ship onto {CROP_CANVAS} px' if canvas else 'full 512 px frames'
        sizes[label] = bytes_uploaded(next(iter(synthetic_loader(
            32, device_aug=True, device_aug_canvas=canvas))), None)
    phase('device aug', 'host-to-device bytes a train batch of 32: '
                        + '; '.join(f'{k} {v}' for k, v in sizes.items()))
    by_path = {}
    for path, label, words in (
            ('device_aug_train', 'full frames, float32', ["precision='float32'"]),
            ('device_aug_train_bf16', 'full frames, bf16', ["precision='bfloat16'"]),
            ('crop_ship_train', f'crop-ship {CROP_CANVAS} px, float32',
             ["precision='float32'", f'device_aug_canvas={CROP_CANVAS}']),
            ('crop_ship_train_bf16', f'crop-ship {CROP_CANVAS} px, bf16',
             ["precision='bfloat16'", f'device_aug_canvas={CROP_CANVAS}'])):
        seen, undo = recording_uploads(train_3d)
        try:
            by_path[path], _, _ = train_bin_phase(
                'device aug', ['margipose_model', 'synthetic', 'device_aug=True', *words],
                DEVICE_AUG_STEPS, path)
        finally:
            undo()
        raw = [fields for fields in seen if 'raw_image' in fields]
        if len(raw) != DEVICE_AUG_STEPS or any('input' in fields for fields in raw):
            raise AssertionError(f'{label}: uploaded {seen}, expected {DEVICE_AUG_STEPS} raw '
                                 f'batches without an input')
        phase('device aug', f'{label}: each train batch uploaded {raw[0]}')

    for canvas in (0, CROP_CANVAS):
        loader = synthetic_loader(32, device_aug=True, device_aug_canvas=canvas)
        batch = dict(next(iter(loader)), specs=specs)
        std = torch.tensor(specs.stddev)
        gpu = aug_input(batch, 'cuda')['input'].cpu()
        cpu = aug_input(batch, 'cpu')['input']
        err = ((gpu - cpu) * std[:, None, None]).abs()
        side = batch['raw_image'].shape[1]
        phase('device aug', f'one augmented batch of 32 ({side} px raw canvas), card vs CPU: max '
                            f'abs err {err.max().item():.3g} in pixel units (atol 1e-5), input '
                            f'{tuple(gpu.shape)} finite {bool(torch.isfinite(gpu).all())}')
        if not (err.max().item() <= 1e-5 and torch.isfinite(gpu).all()):
            raise AssertionError('the aug step on the card disagrees with the CPU\'s')

    raw2 = dict(next(iter(synthetic_loader(2, device_aug=True))), specs=specs)
    step_parity('device aug', 'device-augmented batch of 2 (512 px frames), one train step card '
                              'vs CPU', model, lambda device: aug_input(raw2, device))
    phase('device aug', f'phase 19 took {time.perf_counter() - t_phase:.1f} s')
    return by_path


def ddp_worker(work):
    """A process torchrun starts for phase 20 (``--ddp-worker WORK``): it
    joins torchrun's NCCL process group, takes one train step on its rows of
    the global batch in ``WORK/input.pt`` from the weights there
    (DistributedDataParallel, global batch norm and loss all-reduces),
    traces a step of 32 as phase 8 does (process 0), then runs bin.train_3d's
    flagship path at a global batch of 32 for DDP_STEPS steps and a
    validation batch with every kernel's count and the all-reduces counted
    from 0; writes ``WORK/result<rank>.pt``."""
    import torch.distributed as dist

    from margipose_tpu_torch.bin import train_3d
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
    from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model
    from margipose_tpu_torch.parallel import mesh

    set_float32_parity_mode()
    device = mesh.init_from_env(torch.device('cuda'))
    try:
        inputs = torch.load(os.path.join(work, 'input.pt'))
        model = create_model(Default_MargiPose_Desc).to(device)
        model.load_state_dict(inputs['model'])
        rows = mesh.host_local_slice(len(inputs['batch']['valid_depth']))
        step = train_step_state(model, device, {k: v[rows] for k, v in inputs['batch'].items()})
        rank = mesh.process_index()  # every process traces: the collectives need them all
        train_trace_phase(model, 'float32',
                          'ddp train trace' if rank == 0 else f'ddp train trace, process {rank}')
        real, reduced = mesh.all_reduce_sum, []

        def counting(tensor, group=None):
            reduced.append(tensor.numel())
            return real(tensor, group)

        mesh.all_reduce_sum = counting
        counters = reset_counts()
        try:
            result = train_3d.main(['with', 'margipose_model', 'synthetic', 'epochs=1',
                                    'batch_size=32', f'train_examples={32 * DDP_STEPS}',
                                    "val_datasets=['synthetic-32@1']", 'val_examples=32',
                                    'metrics_every=1', 'seed=9', "precision='float32'",
                                    "ship='float32'", f'out_dir={work}', 'experiment_id=ddp'])
        finally:
            mesh.all_reduce_sum = real
        torch.save({'step': step, 'launches': read_counts(counters), 'result': result,
                    'backend': dist.get_backend(), 'world': mesh.process_count(),
                    'all_reduces': len(reduced), 'device': str(device)},
                   os.path.join(work, f'result{mesh.process_index()}.pt'))
    finally:
        mesh.shutdown()
    return 0


def distributed_phase(model, ckpt, nproc=1):
    """Phase 20: data parallelism. bin.train_3d under ``torch.distributed.run
    --nproc_per_node nproc`` (``ddp_worker``): NCCL, so DistributedDataParallel
    and the global batch-norm and loss all-reduces run even at world size 1;
    both kernels once a step in every process; the processes' train step on
    a global batch of 2 x nproc against one process's non-distributed step
    on the whole batch under the L2 rule, and every process's weights equal.
    Then bin.eval_3d --num-devices nproc against plain eval (the forward once
    a device a batch), and, on one card, --num-devices 2, which must exit
    with the JAX bin's message. Returns the launches by path."""
    from margipose_tpu_torch.bin import eval_3d

    t_phase = time.perf_counter()
    work = os.path.join(WORK, 'ddp')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    batch = flagship_batch(2 * nproc, seed=3)
    torch.save({'model': {k: v.cpu() for k, v in model.state_dict().items()}, 'batch': batch},
               os.path.join(work, 'input.pt'))
    proc = subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--standalone',
                           '--nproc_per_node', str(nproc), os.path.abspath(__file__),
                           '--ddp-worker', work], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith(('torch.distributed:', '[epoch')):
            phase('distributed', f'worker: {line}')
        elif line.startswith('[ddp train trace]'):
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f'the torchrun workers exited {proc.returncode}:\n'
                             f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    outs = [torch.load(os.path.join(work, f'result{r}.pt')) for r in range(nproc)]
    out = outs[0]
    launches, result = out['launches'], out['result']
    expected = {'dsnt_jsd_fwd': DDP_STEPS + 1, 'dsnt_jsd_bwd': DDP_STEPS}
    ms = [t * 1e3 for t in result['step_seconds']]
    phase('distributed', f'bin.train_3d under torchrun: backend {out["backend"]}, world '
                         f'{out["world"]}, {[o["device"] for o in outs]}; kernel launches '
                         f'{[o["launches"] for o in outs]}, expected {expected} in each '
                         f'process; {out["all_reduces"]} all-reduces (batch norm and loss); '
                         f'train loss {result["train_loss"]:.6f}; device ms per step of '
                         f'{32 // nproc} a process: first {ms[0]:.3f}, then '
                         f'{", ".join(f"{m:.3f}" for m in ms[1:])}')
    if (any(o['launches'] != expected for o in outs) or result['step'] != DDP_STEPS
            or out['backend'] != 'nccl' or out['world'] != nproc or not out['all_reduces']
            or not math.isfinite(result['train_loss'])):
        raise AssertionError(f'the train bin under torchrun: {outs}')
    differ = [k for o in outs[1:] for k, v in o['step'][1].items()
              if not torch.equal(v, out['step'][1][k])]
    phase('distributed', f'after the step on a global batch of {2 * nproc}, tensors that differ '
                         f'between processes: {len(differ)}')
    if differ:
        raise AssertionError(f'processes disagree after a step: {differ[:5]}')
    step_parity('distributed', f'one train step on a global batch of {2 * nproc} under the NCCL '
                               f'group ({nproc} process(es), DDP) vs one process\'s '
                               f'non-distributed step on the card', model, lambda device: batch,
                distributed=out['step'])

    argv = ['--model', ckpt, '--dataset', 'synthetic-64', '--batch-size', '32', '--precision',
            'float32', '--ship', 'float32', '--device', 'cuda']
    rows, stats = eval_3d.main(argv)
    counters = reset_counts()
    rows_n, stats_n = eval_3d.main(argv + ['--num-devices', str(nproc)])
    eval_launches = read_counts(counters)
    diffs = {m: float(np.max(np.abs(np.subtract(rows_n[m], rows[m])))) for m in eval_3d.METRICS}
    diff = max(diffs.values())
    loss_rel = abs(stats_n['mean_loss'] - stats['mean_loss']) / abs(stats['mean_loss'])
    # one device runs plain eval's code path: equal. Several run row blocks
    # of 32 / nproc, for which cuDNN picks other algorithms: held as
    # tests/test_torch_eval_bin.py holds the port to JAX (0.1 mm, 1e-3, 1e-4)
    close = (diff <= 1e-6 if nproc == 1 else
             all(v <= (0.1 if 'mpjpe' in m else 1e-3) for m, v in diffs.items())
             and loss_rel <= 1e-4)
    expected = {'dsnt_jsd_fwd': nproc * stats_n['batches'], 'dsnt_jsd_bwd': 0}
    phase('distributed', f'bin.eval_3d --num-devices {nproc}: kernel launches {eval_launches}, '
                         f'expected {expected}; metrics against plain eval max abs diff '
                         f'{diff:.3g}, mean loss {stats_n["mean_loss"]} vs {stats["mean_loss"]} '
                         f'(rel {loss_rel:.3g}); device ms per batch of 32: '
                         f'{", ".join(f"{t * 1e3:.3f}" for t in stats_n["batch_seconds"])}')
    if eval_launches != expected or not close or len(rows_n['mpjpe']) != 64:
        raise AssertionError(f'eval --num-devices {nproc} differs from plain eval')
    if torch.cuda.device_count() == 1:
        try:
            eval_3d.main(argv + ['--num-devices', '2'])
        except SystemExit as exc:
            message = str(exc)
        else:
            raise AssertionError('eval --num-devices 2 ran on a one-card machine')
        phase('distributed', f'bin.eval_3d --num-devices 2 on one card: SystemExit "{message}"')
        if message != 'eval: --num-devices 2 exceeds the 1 available device(s)':
            raise AssertionError(f'eval --num-devices 2 exited with {message!r}')
    phase('distributed', f'phase 20 took {time.perf_counter() - t_phase:.1f} s')
    return {'ddp_train': launches, f'eval_num_devices_{nproc}': eval_launches}


def recording_results(module, name):
    """Wrap ``module.name`` to record each call's result. Returns (the list
    they go to, undo)."""
    real, seen = getattr(module, name), []

    def recording(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    setattr(module, name, recording)
    return seen, lambda: setattr(module, name, real)


def dispatch(*argv):
    """``margipose_tpu_torch.bin.main``, the ``margipose`` command, on the card."""
    from margipose_tpu_torch import bin as cli_bin

    cli_bin.main(['margipose', '--device', 'cuda', *argv])


def hyperparams_phase():
    """Phase 21's kernel path: ``margipose hyperparams`` on the full-width
    flagship, float32, batch 32, HYPERPARAM_ITERS iterations on synthetic-512:
    both kernels once an iteration, lrs geometric from lr_min, losses finite,
    the CSV written. Returns the launches."""
    from margipose_tpu_torch.bin import hyperparam_search

    out_dir = os.path.join(WORK, 'hyperparams')
    shutil.rmtree(out_dir, ignore_errors=True)
    lr_min, lr_max, iters = 1e-4, 1.0, HYPERPARAM_ITERS
    seen, undo = recording_results(hyperparam_search, 'run_lr_range_test')
    t0 = time.perf_counter()
    try:
        _, host, launches = on_card(lambda: dispatch(
            'hyperparams', 'with', 'margipose_model', 'synthetic', 'batch_size=32',
            f'max_iters={iters}', f'lr_min={lr_min}', f'lr_max={lr_max}', f'out_dir={out_dir}'))
    finally:
        undo()
    wall = time.perf_counter() - t0
    (out,) = seen
    ran = len(out['step_seconds'])
    expected, expected_host = loss_head_expected(out['step_counts'], ran, 0)
    lrs = np.geomspace(lr_min, lr_max, iters)
    table = np.loadtxt(os.path.join(out['exp_dir'], 'lr_curve.csv'), delimiter=',', ndmin=2)
    ms = [s * 1e3 for s in out['step_seconds']]
    phase('cli', f'hyperparams, flagship float32 at batch 32: kernels run on the card '
                 f'{launches}, expected {expected} ({ran} iterations of {iters}); host launches '
                 f'{host}, expected {expected_host} ({out["step_counts"]}); '
                 f'{len(out["lrs"])} points recorded, lr {out["lrs"][0]:.3e} .. {out["lrs"][-1]:.3e}, smoothed loss '
                 f'{out["losses"][0]:.6f} .. {out["losses"][-1]:.6f}; lr_curve.csv '
                 f'{table.shape[0]} rows')
    phase('cli', f'hyperparams ms per iteration (CUDA events): first {ms[0]:.3f} (cuDNN\'s '
                 f'algorithm search), then {", ".join(f"{m:.3f}" for m in ms[1:])}; '
                 f'{wall:.1f} s wall for the subcommand (model, loader, iterations, CSV; under '
                 f'the profiler)')
    if not (launches == expected and host == expected_host and ran == iters and out['lrs']
            and np.array_equal(out['lrs'], lrs[:len(out['lrs'])])
            and all(math.isfinite(v) for v in out['losses'])
            and np.array_equal(table, np.stack([out['lrs'], out['losses']], 1))):
        raise AssertionError(f'hyperparams through the dispatcher: {launches}, {out}')
    return launches


def hyperparams_parity_phase(model):
    """The sweep card against CPU, 2 iterations at batch 2 from ``model``'s
    weights (raw losses, ema_beta=0): the two runs of run_lr_range_test,
    losses within rtol 1e-3; then each iteration's update under phase 9's
    L2 rule, card and CPU stepping from the same state (the CPU's weights
    and momentum after the iterations before). Phase 9's rule holds one
    step: over two compounding iterations float32 reordering alone moves
    the stem's batch norms to most of it, which a third sweep measures (the
    CPU at one thread against the CPU at its default threads: the same code,
    sums in another order), so the compounded shares are printed, not
    held."""
    from margipose_tpu_torch.bin import hyperparam_search
    from margipose_tpu_torch.bin.train_3d import device_prefetch
    from margipose_tpu_torch.models import data_specs_for_desc
    from margipose_tpu_torch.train.helpers import create_train_dataloader
    from margipose_tpu_torch.train.steps import TrainState, make_train_step

    cfg = hyperparam_search.ex.parse([
        'with', 'margipose_model', 'synthetic', 'batch_size=2', 'max_iters=2', 'lr_min=1e-3',
        'lr_max=1e-2', 'ema_beta=0.0', 'num_workers=0', 'out_dir='])
    initial = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
    runs = {}
    threads = torch.get_num_threads()
    for name, device, n_threads in (('card', 'cuda', threads), ('cpu', 'cpu', threads),
                                    ('cpu1', 'cpu', 1)):
        m = copy.deepcopy(model).to(device)
        torch.set_num_threads(n_threads)
        try:
            out = hyperparam_search.run_lr_range_test(cfg, device=device, model=m)
        finally:
            torch.set_num_threads(threads)
        runs[name] = (out['losses'], {k: v.detach().cpu().double()
                                      for k, v in m.state_dict().items()})
    (loss_gpu, gpu), (loss_cpu, cpu) = runs['card'], runs['cpu']
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_gpu, loss_cpu))
    compounded = worst_update_share(gpu, cpu, initial)
    floor = worst_update_share(runs['cpu1'][1], cpu, initial)
    phase('cli', f'hyperparams card vs CPU, 2 iterations at batch 2: losses {loss_gpu} vs '
                 f'{loss_cpu}, worst rel err {loss_rel:.3g} (rtol 1e-3); after both '
                 f'iterations the worst parameter tensor at {compounded[0]:.4f} of the L2 rule '
                 f'({compounded[1]}); the CPU at 1 thread against the CPU at {threads}: '
                 f'{floor[0]:.4f} ({floor[1]}); compounded, neither held')
    if not (len(loss_gpu) == len(loss_cpu) == 2 and loss_rel <= 1e-3):
        raise AssertionError('the sweep\'s losses on the card disagree with the CPU\'s')

    # the same iterations from a common state each: the sweep's loader,
    # optimiser and train step, as run_lr_range_test composes them
    lrs = hyperparam_search.sweep_lrs(cfg)
    loader = create_train_dataloader(cfg['train_datasets'], data_specs_for_desc(cfg['model_desc']),
                                     cfg['batch_size'], cfg['max_iters'] * cfg['batch_size'],
                                     cfg['use_aug'], num_workers=0, seed=cfg['seed'])
    step = make_train_step('jsd', torch.float32)
    ref = copy.deepcopy(model).cpu()
    ref_opt = hyperparam_search.make_sweep_optimiser(ref.parameters(), cfg, lrs).state_dict()
    for i, (_, batch) in enumerate(device_prefetch(loader, torch.device('cpu'))):
        start = {k: v.detach().double() for k, v in ref.state_dict().items()}
        results = {}
        for device in ('cuda', 'cpu'):
            m = copy.deepcopy(ref).to(device)
            opt = hyperparam_search.make_sweep_optimiser(m.parameters(), cfg, lrs)
            opt.load_state_dict(copy.deepcopy(ref_opt))
            state = TrainState(m, opt, step=i)
            loss = float(step(state, {k: v.to(device) for k, v in batch.items()})['loss'])
            results[device] = (loss, m, opt)
        (loss_gpu, m_gpu, _), (loss_cpu, ref, opt_cpu) = results['cuda'], results['cpu']
        ref_opt = opt_cpu.state_dict()
        share = worst_update_share(
            {k: v.detach().cpu().double() for k, v in m_gpu.state_dict().items()},
            {k: v.detach().double() for k, v in ref.state_dict().items()}, start)
        rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        phase('cli', f'hyperparams iteration {i} (lr {lrs[i]:.3g}) from a common state, card vs '
                     f'CPU: loss rel err {rel:.3g}; worst parameter tensor at {share[0]:.4f} of '
                     f'10% of its update + 1e-6 RMS ({share[1]})')
        if not (rel <= 1e-3 and share[0] <= 1):
            raise AssertionError(f'sweep iteration {i} on the card disagrees with the CPU\'s')


def export_phase(ckpt_dir):
    """``export_model`` of the train path's checkpoint: native and torch
    reload strict with the checkpoint's tensors and equal outputs; the
    torch.export program reloads on the card, its coordinates within 1e-4
    of the eager forward, both timed at batch 1."""
    from margipose_tpu_torch.bin import export_model
    from margipose_tpu_torch.checkpoint import load_model

    out_dir = os.path.join(WORK, 'export')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    model, _ = load_model(ckpt_dir, 'cuda')
    want = model.state_dict()
    x = flagship_batch(2, seed=21)['input'].cuda()
    with torch.inference_mode():
        xyz = model(x)[0]
    for fmt, name in (('native', 'native'), ('torch', 'model.pth')):
        path = os.path.join(out_dir, name)
        export_model.main(['export_model', '-i', ckpt_dir, '-o', path, '-f', fmt,
                           '--device', 'cuda'])
        reloaded, _ = load_model(path, 'cuda')
        differ = [k for k, v in reloaded.state_dict().items() if not torch.equal(v, want[k])]
        with torch.inference_mode():
            equal = torch.equal(reloaded(x)[0], xyz)
        phase('cli', f'export -f {fmt}: reloaded strict, {len(differ)} tensors differ from the '
                     f'checkpoint, coordinates equal {equal}')
        if differ or not equal:
            raise AssertionError(f'export -f {fmt} does not round-trip: {differ[:5]}')
    path = os.path.join(out_dir, 'model.pt2')
    t0 = time.perf_counter()
    export_model.main(['export_model', '-i', ckpt_dir, '-o', path, '-f', 'export',
                       '--device', 'cuda'])
    export_s = time.perf_counter() - t0
    program = torch.export.load(path).module()
    x1 = x[:1]
    with torch.inference_mode():
        got, eager = program(x1), model(x1)[0]
        err = (got - eager).abs().max().item()
        program_ms = median_ms(lambda: program(x1), reps=5, samples=7)
        eager_ms = median_ms(lambda: model(x1), reps=5, samples=7)
    phase('cli', f'export -f export: {export_s:.1f} s to export and save; reloaded on the card, '
                 f'coordinates {tuple(got.shape)} max abs err {err:.3g} against the eager forward '
                 f'(atol 1e-4); batch 1 ms (CUDA events): exported program {program_ms:.3f}, '
                 f'eager {eager_ms:.3f}')
    if not (err <= 1e-4 and got.shape == (1, 17, 3)):
        raise AssertionError('the exported program disagrees with the eager forward')


def gui_forward_gap(ckpt, seen=None):
    """(examples, coordinates' and last-stage heatmaps' max abs err, the
    heatmaps' peak) of the gui's per-example forward on the card against
    the CPU's, on synthetic-2's two examples of ``ckpt``; ``seen`` holds the
    card's results where the gui made them."""
    from margipose_tpu_torch.bin import run_gui
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
    from margipose_tpu_torch.checkpoint import load_model
    from margipose_tpu_torch.data.get_dataset import get_dataset
    from margipose_tpu_torch.models import data_specs_for_desc

    cpu_model, desc = load_model(ckpt, 'cpu')
    dataset = get_dataset('synthetic-2', data_specs_for_desc(desc), use_aug=False)
    if seen is None:
        set_float32_parity_mode()
        forward = run_gui.make_forward(load_model(ckpt, 'cuda')[0], torch.device('cuda'))
        seen = [run_gui._load_and_process_example(dataset, forward, i) for i in range(2)]
    forward = run_gui.make_forward(cpu_model, torch.device('cpu'))
    coords_err = hm_err = peak = 0.0
    for i, got in enumerate(seen):
        want = run_gui._load_and_process_example(dataset, forward, i)
        coords_err = max(coords_err, float(np.abs(got['pred'] - want['pred']).max()))
        for p in ('xy', 'zy', 'xz'):
            hm_err = max(hm_err, float(np.abs(got['heatmaps'][p] - want['heatmaps'][p]).max()))
            peak = max(peak, float(want['heatmaps'][p].max()))
    return len(seen), coords_err, hm_err, peak


def gui_phase(ckpt):
    """``margipose gui`` on two synthetic-2 examples of the main path's
    checkpoint (the model phase 6 holds card against CPU): each example's
    forward on the card within 1e-4 of the CPU's (coordinates and the last
    stage's heatmaps); the HTML report where matplotlib is installed (its 3D
    pane needs it), else one line. Returns the launches (no loss, so
    none)."""
    import importlib.util

    from margipose_tpu_torch.bin import run_gui

    out_file = os.path.join(WORK, 'gui_report.html')
    counters = reset_counts()
    seen = None
    if importlib.util.find_spec('matplotlib') is not None:
        seen, undo = recording_results(run_gui, '_load_and_process_example')
        try:
            dispatch('gui', '--model', ckpt, '--dataset', 'synthetic-2', '--export-html',
                     out_file, '--examples', '2')
        finally:
            undo()
        with open(out_file) as f:
            html = f.read()
        phase('cli', f'gui: wrote {out_file} ({len(html)} bytes)')
        if not ('<select id="joint">' in html and 'MPJPE' in html):
            raise AssertionError('the gui report lacks its joint selector or metrics')
    else:
        phase('cli', 'gui: matplotlib is not installed here, so the HTML report (its 3D pane '
                     'needs matplotlib) was not rendered; the per-example forward ran alone')
    n, coords_err, hm_err, peak = gui_forward_gap(ckpt, seen)
    launches = read_counts(counters)
    phase('cli', f'gui: {n} examples, forward on the card vs CPU: coordinates max abs '
                 f'err {coords_err:.3g}, last-stage heatmaps {hm_err:.3g} (peak value '
                 f'{peak:.3f}), atol 1e-4; kernel launches {launches}')
    if not (n == 2 and max(coords_err, hm_err) <= 1e-4
            and launches == {'dsnt_jsd_fwd': 0, 'dsnt_jsd_bwd': 0}):
        raise AssertionError('the gui forward on the card disagrees with the CPU\'s')
    return launches


def cli_phase(model, ckpt):
    """Phase 21: the ``margipose`` command (``margipose_tpu_torch.bin.main``)
    on the card: hyperparams (the kernel path), the sweep card against CPU,
    eval through the dispatcher against bin.eval_3d.main and export on phase
    7's model-latest, gui on the main path's checkpoint ``ckpt``,
    calc_dataloader_stats, and bench_loader where h5py is installed. Returns
    the launches by path."""
    import contextlib
    import importlib.util

    from margipose_tpu_torch.bin import calc_dataloader_stats, eval_3d

    t_phase = time.perf_counter()
    by_path = {'hyperparams': hyperparams_phase()}
    hyperparams_parity_phase(model)

    ckpt_dir = os.path.join(WORK, 'train', 'flagship', 'model-latest')  # phase 7's
    args = ['--model', ckpt_dir, '--dataset', 'synthetic-64', '--batch-size', '32',
            '--precision', 'float32']
    rows, _ = eval_3d.main(args + ['--device', 'cuda'])
    seen, undo = recording_results(eval_3d, 'run_evaluation_3d')
    counters = reset_counts()
    try:
        dispatch('eval', *args)
    finally:
        undo()
    by_path['cli_eval'] = read_counts(counters)
    (got, stats), = seen
    equal = all(np.array_equal(got[m], rows[m]) for m in eval_3d.METRICS)
    phase('cli', f'eval through the dispatcher: kernel launches {by_path["cli_eval"]}; metrics '
                 f'equal the direct bin.eval_3d.main call: {equal}; overall '
                 f'{eval_3d.overall_metrics(got)}')
    if not (equal and by_path['cli_eval'] == {'dsnt_jsd_fwd': stats['batches'],
                                              'dsnt_jsd_bwd': 0}):
        raise AssertionError('eval through the dispatcher differs from bin.eval_3d.main')

    export_phase(ckpt_dir)
    by_path['cli_gui'] = gui_phase(ckpt)
    _, coords_err, hm_err, peak = gui_forward_gap(ckpt_dir)
    phase('cli', f'the gui forward on phase 7\'s checkpoint (4 1cycle steps up to lr 1.0), card vs '
                 f'CPU: coordinates {coords_err:.3g}, heatmaps {hm_err:.3g} (peak value '
                 f'{peak:.3f}); not held: the softmax carries the float32 rounding of this '
                 f'checkpoint\'s large logits')

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        calc_dataloader_stats.main(['calc_dataloader_stats', '--dataset', 'synthetic-64',
                                    '--examples', '64', '--out-file',
                                    os.path.join(WORK, 'dataloader_stats.png')])
    lines = text.getvalue().splitlines()
    for line in lines:
        phase('cli', f'calc_dataloader_stats: {line}')
    if not (len(lines) >= 4 and f'n={64 * 17}' in lines[0]):
        raise AssertionError(f'calc_dataloader_stats printed {lines}')

    if importlib.util.find_spec('h5py') is None:
        phase('cli', 'bench_loader: h5py is not installed here, so it did not run (its fake '
                     'MPI-INF-3DHP corpus is HDF5)')
    else:
        from margipose_tpu_torch.bin import bench_loader

        rates = bench_loader.main(['--seconds', '5', '--workers', '0,4'])
        phase('cli', f'bench_loader: host images/s by workers {rates}')
    phase('cli', f'phase 21 took {time.perf_counter() - t_phase:.1f} s')
    return by_path


def counting_collectives():
    """Wrap ``torch.distributed``'s all_reduce and all_gather (the calls
    ``parallel/mesh.py`` makes) to count them. Returns (the counts, undo).
    DistributedDataParallel's bucket all-reduces are made in C++ and are not
    counted."""
    import torch.distributed as dist

    counts = {'all_reduce': 0, 'all_gather': 0}
    real = {name: getattr(dist, name) for name in counts}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return counted

    for name in counts:
        setattr(dist, name, wrap(name))
    return counts, lambda: [setattr(dist, name, fn) for name, fn in real.items()]


def tp_worker(work, d, m, backend):
    """A process torchrun starts for phase 22 (``--tp-worker WORK D M
    BACKEND``): the flagship at full width placed on a (d, m) mesh
    (``mesh.make_mesh``, ``mesh.shard_variables``); one eval batch and one
    train step at 2 rows a data coordinate from the weights and batch in
    ``WORK/input.pt``, with both kernels' launches and the collectives
    counted from 0 around them; the gathered state (process 0) and its
    digest (every process). With ``trace`` in the input, a fresh state's
    train step of 32 global rows, timed by CUDA events and traced. NCCL
    puts process r on ``cuda:LOCAL_RANK``; gloo puts every process on
    ``cuda:0`` (NCCL refuses two ranks on one card; gloo takes CUDA
    tensors on the card's torch 2.11, checked once). Writes
    ``WORK/tp<d>x<m>-<rank>.pt``."""
    import hashlib

    import torch.distributed as dist

    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
    from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model
    from margipose_tpu_torch.parallel import mesh
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, make_eval_step, make_train_step

    set_float32_parity_mode()
    if backend == 'nccl':
        device = mesh.init_from_env(torch.device('cuda'))
    else:
        device = torch.device('cuda', 0)
        torch.cuda.set_device(device)
        dist.init_process_group('gloo')
    try:
        inputs = torch.load(os.path.join(work, 'input.pt'))
        grid = mesh.make_mesh((d, m))
        rank = mesh.process_index()

        def placed():
            with torch.device(device):  # initialised on the card: faster, then overwritten
                model = create_model(Default_MargiPose_Desc)
            model.load_state_dict(inputs['model'])
            return mesh.shard_variables(model, grid)

        model = placed()
        state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, max_iters=10))
        batch = {k: v.to(device) for k, v in mesh.shard_batch(inputs['batch'], grid).items()}
        collectives, undo = counting_collectives()
        counters = reset_counts()
        try:
            evaluated = make_eval_step('jsd', mesh=grid)(model, batch)
            eval_collectives = dict(collectives)
            loss = float(make_train_step('jsd', mesh=grid)(state, batch)['loss'])
        finally:
            undo()
        launches = read_counts(counters)
        train_collectives = {k: v - eval_collectives[k] for k, v in collectives.items()}
        full = mesh.full_state_dict(model)
        digest = hashlib.sha256()
        for key, value in full.items():
            digest.update(key.encode() + value.cpu().numpy().tobytes())
        out = {'loss': loss, 'digest': digest.hexdigest(), 'launches': launches,
               'eval_collectives': eval_collectives, 'train_collectives': train_collectives,
               'eval_loss': float(evaluated['loss']), 'eval_pred': evaluated['pred'].cpu(),
               'coords': grid.coords, 'backend': dist.get_backend(), 'device': str(device),
               'sharded': sum(dim is not None
                              for dim in mesh.param_shardings(grid, model).values()),
               'state': ({k: v.detach().cpu().double() for k, v in full.items()}
                         if rank == 0 else None)}
        del state, model, full
        if inputs['trace']:
            model = placed()
            state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0,
                                                     max_iters=100))
            step = make_train_step('jsd', mesh=grid)
            big = {k: v.to(device) for k, v in
                   mesh.shard_batch(flagship_batch(TP_TRACE_ROWS, seed=5), grid).items()}
            step(state, big)  # cuDNN's algorithm search for these shapes
            collectives, undo = counting_collectives()
            try:
                events, busy, window, _ = profiled(lambda: step(state, big))
            finally:
                undo()
            name = f'tp {d}x{m} trace' + ('' if rank == 0 else f', process {rank}')
            report_trace(name, f'one train step of {TP_TRACE_ROWS} global rows '
                               f'({TP_TRACE_ROWS // d} a process), float32; collectives a step '
                               f'{collectives["all_gather"] // 3} all-gathers, '
                               f'{collectives["all_reduce"] // 3} all-reduces (counted over the '
                               f'warm-up, timed and traced steps)',
                         events, busy, window, TP_TRACE_GROUPS)
            out['trace'] = {'window_ms': window, 'busy_ms': busy,
                            'launches': sum(e.count for e in events),
                            'collectives': {k: v // 3 for k, v in collectives.items()}}
        torch.save(out, os.path.join(work, f'tp{d}x{m}-{rank}.pt'))
    finally:
        mesh.shutdown()
    return 0


def tensor_parallel_phase(model, meshes):
    """Phase 22: the hybrid ('data', 'model') mesh. For each ``(d, m,
    backend, trace)`` in ``meshes``, ``tp_worker`` in d x m processes under
    ``torch.distributed.run``: both kernels once in the eval batch and once
    more in the train step, in every process; every process's gathered
    weights equal bit for bit; the step on 2 rows a data coordinate against
    the card's plain step on the whole batch (phase 9's rules); the eval
    batch's loss and coordinates against the plain eval (phase 6's rules:
    loss rtol 1e-3, coordinates atol 1e-4); a traced step where asked.
    Returns the launches by path (process 0's; all must agree)."""
    from margipose_tpu_torch.train.steps import make_eval_step

    t_phase = time.perf_counter()
    by_path = {}
    for d, m, backend, trace in meshes:
        t0 = time.perf_counter()
        work = os.path.join(WORK, f'tp{d}x{m}')
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        batch = flagship_batch(2 * d, seed=3)
        torch.save({'model': {k: v.cpu() for k, v in model.state_dict().items()}, 'batch': batch,
                    'trace': trace}, os.path.join(work, 'input.pt'))
        proc = subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--standalone',
                               '--nproc_per_node', str(d * m), os.path.abspath(__file__),
                               '--tp-worker', work, str(d), str(m), backend], cwd=ROOT,
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith('[tp '):
                print(line, flush=True)
        if proc.returncode != 0:
            raise AssertionError(f'the {d}x{m} workers exited {proc.returncode}:\n'
                                 f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
        outs = [torch.load(os.path.join(work, f'tp{d}x{m}-{r}.pt')) for r in range(d * m)]
        out = outs[0]
        expected = {'dsnt_jsd_fwd': 2, 'dsnt_jsd_bwd': 1}
        phase('tensor parallel', f'mesh ({d}, {m}), {out["backend"]}, '
                                 f'{[o["device"] for o in outs]}: {out["sharded"]} weights '
                                 f'sharded; '
                                 f'kernel launches {[o["launches"] for o in outs]}, expected '
                                 f'{expected} in each process (one eval batch, one train step); '
                                 f'collectives in the eval batch {out["eval_collectives"]}, in the '
                                 f'train step {out["train_collectives"]}')
        if (any(o['launches'] != expected for o in outs) or out['backend'] != backend
                or [o['coords'] for o in outs] != [{'data': r // m, 'model': r % m}
                                                   for r in range(d * m)]
                or out['sharded'] != (0 if m == 1 else 346)):
            raise AssertionError(f'the {d}x{m} mesh: '
                                 f'{[{k: v for k, v in o.items() if k != "state"} for o in outs]}')
        differ = [r for r, o in enumerate(outs) if o['digest'] != out['digest']]
        phase('tensor parallel', f'mesh ({d}, {m}): processes whose gathered weights differ from '
                                 f'process 0\'s: {differ}')
        if differ:
            raise AssertionError(f'the {d}x{m} mesh\'s processes disagree: {differ}')
        step_parity('tensor parallel', f'mesh ({d}, {m}), one train step on a global batch of '
                                       f'{2 * d} vs one process\'s plain step on the card',
                    model, lambda device: batch, distributed=(out['loss'], out['state']))
        plain = make_eval_step('jsd')(model, {k: v.cuda() for k, v in batch.items()})
        pred = torch.cat([outs[i * m]['eval_pred'] for i in range(d)])
        err = (pred - plain['pred'].cpu()).abs().max().item()
        rel = abs(out['eval_loss'] - float(plain['loss'])) / abs(float(plain['loss']))
        phase('tensor parallel', f'mesh ({d}, {m}), one eval batch of {2 * d}: coordinates max '
                                 f'abs err {err:.3g} (atol 1e-4), loss rel err {rel:.3g} (rtol '
                                 f'1e-3) against the plain eval on the card')
        if not (err <= 1e-4 and rel <= 1e-3 and all(
                abs(o['eval_loss'] - out['eval_loss']) <= 1e-6 * abs(out['eval_loss'])
                for o in outs)):
            raise AssertionError(f'the {d}x{m} mesh\'s eval batch disagrees')
        if trace:
            ms = [o['trace']['window_ms'] for o in outs]
            phase('tensor parallel', f'mesh ({d}, {m}): a train step of {TP_TRACE_ROWS} global '
                                     f'rows, window by process {", ".join(f"{t:.3f}" for t in ms)} '
                                     f'ms; process 0 {out["trace"]}')
        by_path[f'tensor_parallel_{d}x{m}'] = out['launches']
        phase('tensor parallel', f'mesh ({d}, {m}) took {time.perf_counter() - t0:.1f} s')
    phase('tensor parallel', f'phase 22 took {time.perf_counter() - t_phase:.1f} s')
    return by_path


def soak_report(label, exp_dir, name='soak'):
    """The soak verifier on ``exp_dir``, run in this process (not the one
    that trained), its lines printed, then the launches, step times and save
    times the training process that ended recorded; raises on a FAIL or on
    launches that are not one of each kernel a step. Returns the launches."""
    from margipose_tpu_torch.soak import verify

    checks = verify.verify(exp_dir, out=lambda line: phase(name, f'{label}: {line}'))
    with open(os.path.join(exp_dir, 'soak_run.json')) as f:
        record = json.load(f)
    steps = record['step'] - record['start_step']
    launches, counts = record['launches'], record['step_counts']
    host = counts['eager_steps'] + counts['captures']
    ms = np.array(record['step_seconds']) * 1e3
    copy_ms = np.array(record['save_copy_seconds']) * 1e3
    write_ms = np.array(record['save_write_seconds']) * 1e3
    phase(name, f'{label}: host launches {launches} in the {steps} steps of the training '
                f'process that ended (counted from 0 in it: {counts}), expected one of each an '
                f'eager or capturing step; '
                f'device ms a step: first {ms[0]:.3f}, then min {ms[1:].min():.3f}, p10 '
                f'{np.percentile(ms[1:], 10):.3f}, median {np.median(ms[1:]):.3f}, p90 '
                f'{np.percentile(ms[1:], 90):.3f}, p99 {np.percentile(ms[1:], 99):.3f}, max '
                f'{ms[1:].max():.3f}; {len(copy_ms)} saves: host copy median '
                f'{np.median(copy_ms):.1f} ms (the loop waits for it), write and swap median '
                f'{np.median(write_ms):.1f} ms (in the background); process wall '
                f'{record["wall_seconds"]:.1f} s')
    if (not checks.ok or steps < 2 or sum(counts.values()) != steps
            or launches != {'dsnt_jsd_fwd': host, 'dsnt_jsd_bwd': host}):
        raise AssertionError(f'the {label} soak: verifier ok {checks.ok}, launches {launches} '
                             f'in {steps} steps')
    return launches


def soak_phase():
    """Phase 23: the full-schedule soak cut to SOAK_EPOCHS epochs of 8 steps
    on synthetic data (the recipe's model, batch, lr, device aug and
    checkpoints), SIGKILLed once epoch SOAK_KILL_AT is saved and resumed;
    then, side by side on the card, Chatterbox for SOAK_CHATTERBOX_EPOCHS
    epochs and the planted faults' resume (so their step times share the
    card; the full schedule's resumed run has it alone); each run verified
    here, in a process that never held its trained state, and each planted
    fault (a resume whose restored optimiser count is one update short, BN
    running statistics reset in model-latest, an epoch's records removed)
    made to fail the verifier on its own check. Returns the launches by
    path (the training process that ended)."""
    from margipose_tpu_torch.soak import faults, run, verify

    t_phase = time.perf_counter()
    out = os.path.join(WORK, 'soak')
    shutil.rmtree(out, ignore_errors=True)
    planted = os.path.join(out, 'planted')
    overrides = [f'epochs={SOAK_EPOCHS}']
    exp = run.run_recipe('full-schedule', 'synthetic', out, 'cuda', kill_at=SOAK_KILL_AT,
                         overrides=overrides, keep_killed=True, timeout=600,
                         log=lambda line: phase('soak', f'full schedule: {line}'))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cb = pool.submit(run.run_recipe, 'chatterbox', 'synthetic', out, 'cuda',
                         overrides=[f'epochs={SOAK_CHATTERBOX_EPOCHS}'], timeout=600,
                         log=lambda line: phase('soak', f'chatterbox: {line}'))
        short = pool.submit(faults.count_off_by_one, exp + '.killed',
                            os.path.join(planted, 'count'), 'full-schedule', 'synthetic', 'cuda',
                            overrides, timeout=600)
        by_path = {'soak_full_schedule': soak_report(f'full schedule, {SOAK_EPOCHS} epochs', exp)}
        by_path['soak_chatterbox'] = soak_report(
            f'chatterbox, {SOAK_CHATTERBOX_EPOCHS} epochs (beside a planted fault\'s run)',
            cb.result())
        made = {'count': short.result(),
                'batch_norm': faults.batch_norm_reset(exp, os.path.join(planted, 'bn')),
                'missing_epoch': faults.missing_epoch(exp, os.path.join(planted, 'epoch'),
                                                      SOAK_KILL_AT)}
    for kind, exp_dir in made.items():
        checks = verify.verify(exp_dir, out=lambda line: None)
        failed = [line for line in checks.lines if line.startswith('[FAIL]')]
        phase('soak', f'planted fault {kind}: the verifier FAILs {len(failed)} check(s): '
                      + ' | '.join(failed))
        if checks.ok or not any(faults.CAUGHT_BY[kind] in line for line in failed):
            raise AssertionError(f'the verifier missed the planted {kind} fault')
    phase('soak', f'phase 23 took {time.perf_counter() - t_phase:.1f} s')
    return by_path


def soak_main():
    """``python3 chip_smoke.py --soak``: the soaks at their full length on the
    card. The 150-epoch schedule on synthetic data, SIGKILLed once epoch 75
    is saved, resumed, SIGKILLed halfway through epoch 110's save, resumed
    from ``state.old``; Chatterbox for 6 epochs; each verified; the same on
    the fake corpus where h5py is installed."""
    import importlib.util

    from margipose_tpu_torch.soak import corpus, run

    if not torch.cuda.is_available():
        print('chip_smoke --soak: torch.cuda.is_available() is False; this mode needs a CUDA '
              'card', file=sys.stderr)
        return 1
    kind, _ = device_phase()
    build_phase()
    datasets = ['synthetic']
    if importlib.util.find_spec('h5py') is None:
        phase('soak', 'the fake corpus is HDF5 and h5py is not installed here: the soaks run on '
                      'synthetic data only')
    else:
        corpus.use_fake_corpus(os.path.join(WORK, 'soak-data'))
        datasets.append('fake')
    by_path = {}
    for dataset in datasets:
        out = os.path.join(WORK, f'soak-{dataset}')
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        exp = run.run_recipe('full-schedule', dataset, out, 'cuda', kill_at=75, kill_in_save=110,
                             timeout=3000, log=lambda line: phase('soak', f'{dataset}: {line}'))
        by_path[f'soak_full_schedule_{dataset}'] = soak_report(
            f'{dataset}, full schedule, 150 epochs', exp)
        phase('soak', f'{dataset}: the full schedule took {time.perf_counter() - t0:.1f} s wall')
        t0 = time.perf_counter()
        cb = run.run_recipe('chatterbox', dataset, out, 'cuda', timeout=3000,
                            log=lambda line: phase('soak', f'{dataset}: chatterbox: {line}'))
        by_path[f'soak_chatterbox_{dataset}'] = soak_report(f'{dataset}, chatterbox, 6 epochs', cb)
        phase('soak', f'{dataset}: chatterbox took {time.perf_counter() - t0:.1f} s wall')
    print(json.dumps({'launches_by_path': by_path}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


def two_node_phase(n):
    """``--multi-gpu``: the launcher's multi-node command rehearsed on the
    machine's n cards as two torchrun agents of n / 2 workers, each agent
    with its own cards (``CUDA_VISIBLE_DEVICES``) and the argv
    ``gpu_cluster.torchrun_argv`` gives pods 0 and 1 (``deploy/rehearsal.py``):
    the train bin, float32, REHEARSAL_STEPS steps of 32 global rows (one an
    epoch), SIGKILLed with every worker once the first checkpoint is saved,
    resumed across both agents. Global ranks 0..n-1 each on
    cuda:LOCAL_RANK of its agent's cards, only rank 0 writing, every
    process's weights bit-equal after each step, both kernels once a step;
    the first step within phase 9's rules of one agent's
    ``--standalone --nproc-per-node n`` step (its first checkpoint: killed
    and resumed the same way). Returns the launches."""
    from margipose_tpu_torch.deploy import rehearsal
    from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model
    from margipose_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    half = n // 2
    cards = [','.join(str(c) for c in range(k * half, (k + 1) * half)) for k in range(2)]
    words = ['--device', 'cuda', 'train', 'with', 'margipose_model', 'synthetic',
             'batch_size=32', 'train_examples=32', 'val_examples=0', 'val_datasets=[]',
             "precision='float32'", "ship='float32'", 'checkpoint_every=1', 'seed=9']
    out = os.path.join(WORK, 'two-node-out')
    shutil.rmtree(out, ignore_errors=True)
    exp = os.path.join(out, 'two-node')
    launches = rehearsal.rehearse(
        words + [f'epochs={REHEARSAL_STEPS}', f'out_dir={out}', 'experiment_id=two-node'],
        os.path.join(WORK, 'two-node'), out, nodes=2, procs_per_node=half, cards=cards,
        kill_at=1, exp_dir=exp, timeout=300, log=lambda line: phase('two nodes', line))
    for i, processes in enumerate(launches, 1):
        heads = sorted((p[0] for p in processes), key=lambda h: h['rank'])
        steps = [[r for r in p if 'step' in r] for p in processes]
        placed = sorted({(p[0]['rank'], p[0]['local_rank'], p[0]['visible'], r['device'], r['card'])
                         for p, ss in zip(processes, steps) for r in ss})
        writers = sorted({p[0]['rank'] for p in processes if any('write' in r for r in p)})
        phase('two nodes', f'launch {i}: (global rank, local rank, CUDA_VISIBLE_DEVICES, device, '
                           f'card) {placed}; processes that wrote under the output directory: '
                           f'ranks {writers}')
        if ([h['rank'] for h in heads] != list(range(n))
                or any(h['world'] != n or h['local_rank'] != h['rank'] % half
                       or h['visible'] != cards[h['rank'] // half] for h in heads)
                or any(r['device'] != f'cuda:{p[0]["local_rank"]}'
                       for p, ss in zip(processes, steps) for r in ss)
                or len({r['card'] for ss in steps for r in ss}) != n or writers != [0]):
            raise AssertionError(f'launch {i} of the two-node rehearsal: {heads}, {placed}, '
                                 f'writers {writers}')
        by_step = {}
        for ss in steps:
            for r in ss:
                by_step.setdefault(r['step'], []).append(r)
        for step, rs in sorted(by_step.items()):
            # the kill may cut the killed launch's last step short in some
            # processes; every process saw the steps a checkpoint followed
            whole = len(rs) == n or (i < len(launches) and step > 1)
            equal = len({r['digest'] for r in rs}) == 1
            counts = {tuple(r['launches']) for r in rs}
            phase('two nodes', f'launch {i}, step {step}: {len(rs)} processes, weights '
                               f'bit-equal {equal}; kernel launches so far (fwd, bwd) {counts}')
            if not (equal and whole):
                raise AssertionError(f'the processes disagree after step {step}')
        # each process's counts after its k-th step: k of each kernel
        if any([tuple(r['launches']) for r in ss] != [(k, k) for k in range(1, len(ss) + 1)]
               for ss in steps):
            raise AssertionError(f'launch {i}: kernel launches not one of each a step')
    resumed = [r['step'] for r in launches[-1][0] if 'step' in r]
    if resumed[-1] != REHEARSAL_STEPS:
        raise AssertionError(f'the resumed launch ended at step {resumed[-1]}')

    # one agent of n workers, the same schedule (its lr depends on the
    # run's length), killed after its first checkpoint too
    one_out = os.path.join(WORK, 'one-agent-out')
    shutil.rmtree(one_out, ignore_errors=True)
    rehearsal.rehearse(
        words + [f'epochs={REHEARSAL_STEPS}', f'out_dir={one_out}', 'experiment_id=one-agent'],
        os.path.join(WORK, 'one-agent'), one_out, nodes=1, procs_per_node=n, kill_at=1,
        exp_dir=os.path.join(one_out, 'one-agent'), timeout=300,
        log=lambda line: phase('two nodes', f'one agent: {line}'))
    first = [os.path.join(WORK, run, 'model-latest.killed') for run in ('two-node', 'one-agent')]
    if any(ckpt.load_meta(ckpt_dir)['epoch'] != 1 for ckpt_dir in first):
        raise AssertionError('a kill left a checkpoint past the first step; run again')
    initial = {k: v.double() for k, v in create_model(
        Default_MargiPose_Desc, generator=torch.Generator().manual_seed(9)).state_dict().items()}
    got, want = ({k: v.double() for k, v in ckpt.load_payload(ckpt_dir)['model'].items()}
                 for ckpt_dir in first)
    share = worst_update_share(got, want, initial)
    worst_buffer = max(((got[k] - want[k]).abs() / (1e-5 + 1e-4 * want[k].abs())).max().item()
                       for k in want if 'running_' in k)
    final = ckpt.load_payload(os.path.join(exp, 'model-latest'))
    phase('two nodes', f'the first step of 32 global rows, two agents of {half} vs one agent of '
                       f'{n}: worst parameter tensor at {share[0]:.4f} of 10% of its update + '
                       f'1e-6 RMS ({share[1]}), worst BN buffer at {worst_buffer:.3g}; the resumed '
                       f'run ended at step {final["step"]}, epoch '
                       f'{ckpt.load_meta(os.path.join(exp, "model-latest"))["epoch"]}')
    if not (share[0] <= 1 and worst_buffer <= 1 and final['step'] == REHEARSAL_STEPS):
        raise AssertionError('the two-node step disagrees with one agent\'s')
    phase('two nodes', f'took {time.perf_counter() - t_phase:.1f} s')
    return {'two_node': {'dsnt_jsd_fwd': len(resumed), 'dsnt_jsd_bwd': len(resumed)}}


def multi_gpu_main():
    """``python3 chip_smoke.py --multi-gpu``, on a machine with several
    cards: the build, phase 20 across every card (NCCL between them) and
    phase 22 on the meshes (n/2, 2) and (1, n), each with a traced train
    step of 32 global rows, nothing else. Exits 1 on a machine with fewer
    than two cards."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f'chip_smoke --multi-gpu: {n} CUDA card(s); this mode needs two or more',
              file=sys.stderr)
        return 1
    kind, _ = device_phase()
    build_phase()
    from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
    from margipose_tpu_torch.checkpoint import save_model
    from margipose_tpu_torch.models import Default_MargiPose_Desc

    set_float32_parity_mode()
    model = flagship('cuda')
    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, 'margipose-flagship-random.pth')
    save_model(ckpt, model, Default_MargiPose_Desc)
    by_path = distributed_phase(model, ckpt, n)
    by_path.update(tensor_parallel_phase(model, [(n // 2, 2, 'nccl', True),
                                                 (1, n, 'nccl', True)]))
    if n >= 4:
        by_path.update(two_node_phase(n))
    print(json.dumps({'launches_by_path': by_path}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': n}}),
          flush=True)
    return 0


# the volumetric soft-argmax's shapes, (B, J, D, H, W): logits [B, J * D, H, W]
SOFTARGMAX3D_SHAPES = [
    (32, 17, 64, 64, 64),  # the integral model's at batch 32: 544 rows of 64^3
    (2, 17, 8, 16, 16),    # the CPU tests' model (64 px, D = 8)
    (1, 5, 3, 5, 24),      # odd D and H: the cluster's slices split rows unevenly
]
INTEGRAL_STEPS = 4         # the integral train path's steps at batch 32
INTEGRAL_GROUPS = [('convolutions', CONV_WORDS), ('batch norm', ('batch_norm', 'bn_')),
                   ('softargmax3d_fwd', ('softargmax3d_fwd',)),
                   ('softargmax3d_bwd', ('softargmax3d_bwd',)),
                   ('optimiser', ('multi_tensor', 'foreach', 'sgd')),
                   ('copies and casts', ('copy',))]


def softargmax3d_bytes(rows, volume, width, direction):
    """The least bytes the kernel moves: logits read once (and their gradient
    written once), the rows' float32 coordinates, statistics and cotangent."""
    if direction == 'fwd':
        return rows * volume * width + rows * 5 * 4
    return 2 * rows * volume * width + rows * 8 * 4


def softargmax3d_phase():
    """Both soft-argmax kernels against their plain versions on the card, in
    float32 and bf16, at the integral model's shape and two small ones:
    coordinates within ATOL_KERNEL, the statistics within 1e-6 (m) and
    1e-5 (s) relative, the gradient within a bf16 ulp (float32: 1e-4) of
    each element plus 1e-5 of the largest; autograd through the CUDA path against
    autograd through the plain one; times in a CUDA graph against the bytes
    bound, and the plain versions' eager times."""
    from margipose_tpu_torch.ops import softargmax3d as sa

    reports = []
    for b, j, d, h, w in SOFTARGMAX3D_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device='cuda').manual_seed(1000 * b + d)
            # logits of std 3: the largest voxel 1e-3 to 0.5 of a joint's mass
            logits = (3 * torch.randn(b, j * d, h, w, generator=g, device='cuda')).to(dtype)
            grad = torch.randn(b, j, 3, generator=g, device='cuda')
            counters = reset_counts(SOFTARGMAX3D_KERNELS)
            xyz, stats = sa.softargmax3d_fwd(logits, d)
            dl = sa.softargmax3d_bwd(logits, d, xyz, stats, grad)
            torch.cuda.synchronize()
            launches = read_counts(counters)
            want_xyz, want_stats = sa.softargmax3d_fwd_plain(logits, d)
            want_dl = sa.softargmax3d_bwd_plain(logits, d, want_xyz, want_stats, grad).float()
            xyz_gap = float((xyz - want_xyz).abs().max())
            m_gap = float(((stats[:, 0] - want_stats[:, 0]).abs()
                           / want_stats[:, 0].abs().clamp(min=1.0)).max())
            s_gap = float(((stats[:, 1] - want_stats[:, 1]).abs() / want_stats[:, 1]).max())
            top = float(want_dl.abs().max())
            rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
            excess = float(((dl.float() - want_dl).abs() - rtol * want_dl.abs()).max()) / top
            lc = logits.clone().requires_grad_()
            lp = logits.clone().requires_grad_()
            sa.softargmax3d(lc, d).backward(grad)
            sa.softargmax3d_plain(lp, d).backward(grad)
            autograd_excess = float(((lc.grad.float() - lp.grad.float()).abs()
                                     - rtol * lp.grad.float().abs()).max()) / top
            peak = float(torch.softmax(logits.float().reshape(b * j, -1), -1).amax(-1).median())
            name = f'softargmax3d {b}x{j}x{d}x{h}x{w} {str(dtype)[6:]}'
            phase(name, f'launches {launches}; xyz gap {xyz_gap:.3e}, m gap {m_gap:.3e}, s gap '
                        f'{s_gap:.3e}, dl excess over {rtol:.3g} x |dl| {excess:.3e} of the '
                        f'largest {top:.3e}, autograd {autograd_excess:.3e}; median largest '
                        f'voxel {peak:.3e}')
            if not (launches == {'softargmax3d_fwd': 1, 'softargmax3d_bwd': 1}
                    and xyz_gap <= ATOL_KERNEL and m_gap <= 1e-6 and s_gap <= 1e-5
                    and excess <= 1e-5 and autograd_excess <= 1e-5):
                raise AssertionError(f'{name}: the kernels left their plain versions')
            rows, volume, width = b * j, d * h * w, logits.element_size()
            times = {'fwd': graph_ms(lambda: sa.softargmax3d_fwd(logits, d)),
                     'bwd': graph_ms(lambda: sa.softargmax3d_bwd(logits, d, xyz, stats, grad))}
            plain = {'fwd': median_ms(lambda: sa.softargmax3d_fwd_plain(logits, d), 3, 5),
                     'bwd': median_ms(lambda: sa.softargmax3d_bwd_plain(
                         logits, d, want_xyz, want_stats, grad), 3, 5)}
            for direction in ('fwd', 'bwd'):
                nbytes = softargmax3d_bytes(rows, volume, width, direction)
                bound_us = nbytes / HBM_BYTES_PER_S * 1e6
                us = times[direction] * 1e3
                phase(name, f'{direction}: {us:.2f} us in a CUDA graph, bound {bound_us:.2f} us '
                            f'(bytes), {100 * bound_us / us:.1f}% of it; plain version '
                            f'{plain[direction] * 1e3:.2f} us (eager)')
                reports.append({'name': f'softargmax3d_{direction}', 'shape': [b, j, d, h, w],
                                'dtype': str(dtype)[6:], 'us': us, 'bound_us': bound_us,
                                'plain_us': plain[direction] * 1e3})
            del logits, lc, lp, want_dl, dl
    torch.cuda.empty_cache()
    return reports


def integral_phase():
    """The integral model (Default_Integral_Desc: ResNet-50, D = 64, 256 px)
    on its paths: bin.train_3d with the integral_model preset at batch 32 in
    bf16 (INTEGRAL_STEPS steps and a validation batch; the soft-argmax
    kernels counted from a device trace: the forward once a step and a
    validation batch, the backward once a step, no loss-head kernel);
    bin.eval_3d on the checkpoint in float32 and bf16, infer_single and the
    serve runner (the forward kernel once a batch); 6 bf16 steps replayed
    from the step's CUDA graph against 6 eager ones, within the graph
    limits, and a replayed step's device time by kernel group."""
    from margipose_tpu_torch.bin import eval_3d, infer_single, serve, train_3d
    from margipose_tpu_torch.checkpoint import load_model
    from margipose_tpu_torch.models import (
        Default_Integral_Desc,
        create_model,
        data_specs_for_desc,
    )
    from margipose_tpu_torch.train import checkpoint
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.train.steps import TrainState, eager, make_train_step, step_counts

    kernels = SOFTARGMAX3D_KERNELS + LOSS_HEAD_KERNELS
    out_dir = os.path.join(WORK, 'integral')
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, val_batches = INTEGRAL_STEPS, 1
    torch.cuda.reset_peak_memory_stats()
    result, host, ran = on_card(lambda: train_3d.main(
        ['with', 'integral_model', 'synthetic', 'epochs=1', 'batch_size=32',
         f'train_examples={32 * steps}', "val_datasets=['synthetic-32@1']", 'val_examples=32',
         'metrics_every=1', 'seed=7', f'out_dir={out_dir}', 'experiment_id=integral']), kernels)
    counts = result['step_counts']
    launched = counts['eager_steps'] + counts['captures']
    want_ran = {'softargmax3d_fwd': steps + val_batches, 'softargmax3d_bwd': steps,
                'dsnt_jsd_fwd': 0, 'dsnt_jsd_bwd': 0}
    want_host = {'softargmax3d_fwd': launched + val_batches, 'softargmax3d_bwd': launched,
                 'dsnt_jsd_fwd': 0, 'dsnt_jsd_bwd': 0}
    ms = [t * 1e3 for t in result['step_seconds']]
    phase('integral train', f'kernels run {ran} (expected {want_ran}), host launches {host} '
                            f'(expected {want_host}; {counts}); train loss '
                            f'{result["train_loss"]:.6f}; device ms a step of 32: '
                            + ', '.join(f'{m:.3f}' for m in ms) + '; peak memory '
                            f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    if (ran != want_ran or host != want_host or result['step'] != steps
            or not math.isfinite(result['train_loss'])):
        raise AssertionError('integral train path: kernels, steps or loss off')

    ckpt_dir = os.path.join(out_dir, 'integral', 'model-latest')
    check_batch_norm_ran('integral train',  # the bin's precision on the card: bf16
                         batch_norm_layers(checkpoint.load_payload(ckpt_dir)['model']), steps,
                         channels_last=True)
    by_path = {}
    for precision in ('float32', 'bfloat16'):
        (rows, stats), host, ran = on_card(lambda: eval_3d.main(
            ['--model', ckpt_dir, '--dataset', 'synthetic-64', '--batch-size', '32',
             '--precision', precision, '--device', 'cuda']), kernels)
        want = {'softargmax3d_fwd': 2, 'softargmax3d_bwd': 0, 'dsnt_jsd_fwd': 0, 'dsnt_jsd_bwd': 0}
        finite = all(math.isfinite(v) for m in eval_3d.METRICS for v in rows[m])
        phase('integral eval', f'{precision}: kernels run {ran}, host {host} (expected {want}); '
                               f'overall {eval_3d.overall_metrics(rows)}, mean loss '
                               f'{stats["mean_loss"]}')
        if ran != want or host != want or not finite or len(rows['mpjpe']) != 64:
            raise AssertionError(f'integral eval ({precision}): kernels or metrics off')
        by_path[f'integral_eval_{precision}'] = host
    model, desc = load_model(ckpt_dir, 'cuda')
    import PIL.Image

    (_, coords), host, ran = on_card(lambda: infer_single.infer_image(
        model, PIL.Image.open(IMAGE), desc, device='cuda'), kernels)
    runner = serve.model_runner(model, data_specs_for_desc(desc).input_specs, 'bfloat16',
                                torch.device('cuda'))
    frames = np.random.default_rng(3).integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    served, serve_host, serve_ran = on_card(lambda: runner(frames), kernels)
    phase('integral infer', f'kernels run {ran}, host {host}; coordinates finite '
                            f'{bool(np.isfinite(coords).all())}; serve runner at batch 8 in bf16: '
                            f'kernels run {serve_ran}, answers {served.shape} finite '
                            f'{bool(np.isfinite(served).all())}')
    want = {'softargmax3d_fwd': 1, 'softargmax3d_bwd': 0, 'dsnt_jsd_fwd': 0, 'dsnt_jsd_bwd': 0}
    if not (ran == host == serve_ran == serve_host == want and np.isfinite(coords).all()
            and np.isfinite(served).all()):
        raise AssertionError('integral infer or serve: kernels or answers off')
    by_path['integral_infer'], by_path['integral_serve'] = host, serve_host
    del model, runner

    base = create_model(Default_Integral_Desc, generator=torch.Generator().manual_seed(0))
    base = base.cuda()
    states, step_fns, losses = [], [], [[], []]
    for _ in range(2):
        m = copy.deepcopy(base)
        states.append(TrainState(m, make_optimiser('1cycle', m.parameters(), 1.0, max_iters=100)))
        step_fns.append(make_train_step('jsd', 'bfloat16'))
    start = {k: p.detach().clone() for k, p in base.named_parameters()}
    del base
    for seed in range(6):
        batch = {k: v.cuda() for k, v in flagship_batch(32, seed=60 + seed).items()}
        losses[0].append(step_fns[0](states[0], batch)['loss'])
        losses[1].append(eager(step_fns[1], states[1], batch)['loss'])
    got, want = (torch.stack(x).double().cpu().numpy() for x in losses)
    loss_gap = float(np.max(np.abs(got - want) / np.abs(want)))
    change = [{k: float((p.detach() - start[k]).norm()) for k, p in s.model.named_parameters()}
              for s in states]
    update_gap, worst = median_leaf_gap(*change)
    counts = step_counts(step_fns[0])
    phase('integral graph', f'bf16 graphed vs eager over 6 steps (mixed 2D/3D rows): loss gap '
                            f'{loss_gap:.3e} (limit {GRAPH_LOSS_GAP}), update gap median '
                            f'{update_gap:.3e} (limit {GRAPH_UPDATE_GAP}), worst leaf '
                            f'{worst:.3e}; losses {got.tolist()}; counts {counts}')
    if not (loss_gap <= GRAPH_LOSS_GAP and update_gap <= GRAPH_UPDATE_GAP
            and counts == {'eager_steps': 1, 'captures': 1, 'replays': 4}
            and np.isfinite(got).all()):
        raise AssertionError('integral graph: the graphed step left the eager one or did not '
                             'replay')
    batch = {k: v.cuda() for k, v in flagship_batch(32, seed=5).items()}
    _, host, ran = on_card(lambda: step_fns[0](states[0], batch), kernels)
    phase('integral graph', f'one replayed step: kernels run {ran}, host launches {host}')
    if ran != {'softargmax3d_fwd': 1, 'softargmax3d_bwd': 1, 'dsnt_jsd_fwd': 0,
               'dsnt_jsd_bwd': 0} or any(host.values()):
        raise AssertionError('integral graph: a replayed step ran other kernels')
    replayed = profiled(lambda: step_fns[0](states[0], batch))
    report_trace('integral graph', 'one replayed bf16 train step of 32', *replayed[:3],
                 INTEGRAL_GROUPS)
    eagerly = profiled(lambda: eager(step_fns[1], states[1], batch))
    report_trace('integral graph', 'one eager bf16 train step of 32', *eagerly[:3],
                 INTEGRAL_GROUPS)
    del states, step_fns
    torch.cuda.empty_cache()
    return by_path


# train-mode batch norm's shapes, (B, C, H, W, pointer offset in values): the
# train cells' at batch 32 (flagship: 180 layers of 192x16x16, 145 of
# 128x32x32, 36 of 17x32x32, the stem's 96x64x64 and 32/64x128x128, whose
# bf16 backward and float32 take the split path; integral: 256x64x64,
# 512x32x32, 1024x16x16, 2048x8x8), then the single-value layouts
BATCH_NORM_SHAPES = [
    (32, 192, 16, 16, 0), (32, 128, 32, 32, 0), (32, 17, 32, 32, 0), (32, 96, 64, 64, 0),
    (32, 32, 128, 128, 0), (32, 64, 128, 128, 0), (32, 256, 64, 64, 0), (32, 512, 32, 32, 0),
    (32, 1024, 16, 16, 0), (32, 2048, 8, 8, 0),
    (2, 6, 7, 9, 0),      # H * W = 63: single values
    (3, 5, 1, 1, 0),      # n = 3
    (2, 24, 16, 16, 1),   # off 16-byte alignment: single values
]
BATCH_NORM_TIMED = 10      # the first shapes, timed
BATCH_NORM_EPS = 1e-3      # BasicConv2d's; the other batch norms take 1e-5
BATCH_NORM_STEPS = 4       # graphed against eager train steps at batch 32


def batch_norm_inputs(b, c, h, w, offset, dtype, seed, channels_last=False):
    """x (mean about 0.5, std 2, ``offset`` values into its storage; NCHW,
    or channels-last), the cotangent dy in x's layout, and float32 weight,
    bias, running mean and variance."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    numel = b * c * h * w
    storage = torch.empty(numel + offset, dtype=dtype, device='cuda')[offset:]
    x = storage.view(b, h, w, c).permute(0, 3, 1, 2) if channels_last else storage.view(b, c, h, w)
    x.copy_(2 * torch.randn(b, c, h, w, generator=g, device='cuda') + 0.5)
    dy = torch.randn(b, c, h, w, generator=g, device='cuda').to(dtype)
    if channels_last:
        dy = dy.contiguous(memory_format=torch.channels_last)
    params = [torch.rand(c, generator=g, device='cuda') + 0.5,
              torch.randn(c, generator=g, device='cuda') * 0.1,
              torch.randn(c, generator=g, device='cuda') * 0.1,
              torch.rand(c, generator=g, device='cuda') + 0.5]
    return x, dy, params


def batch_norm_run(fn, x, dy, params, momentum):
    """y, dx, dweight, dbias and the running statistics after ``fn``."""
    weight, bias = (p.clone().requires_grad_() for p in params[:2])
    mean, var = (p.clone() for p in params[2:])
    tracked = torch.zeros((), dtype=torch.long, device='cuda')
    xr = x.detach().requires_grad_()  # x's storage: its offset kept
    y = fn(xr, weight, bias, mean, var, tracked, momentum, BATCH_NORM_EPS)
    y.backward(dy)
    return {'y': y.detach(), 'dx': xr.grad, 'dw': weight.grad, 'db': bias.grad,
            'running_mean': mean, 'running_var': var, 'tracked': tracked}


def batch_norm_exact(x, dy, params, momentum):
    """batch_norm_run's outputs in float64 from the same inputs (x and dy
    as given, in their dtype), for one step from a reset counter."""
    weight, bias, mean, var = (p.double() for p in params)
    xf, dyf = x.double(), dy.double()
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1]
    mu = xf.mean(dims)
    v = xf.var(dims, unbiased=False)
    invstd = 1 / (v + BATCH_NORM_EPS).sqrt()
    xhat = (xf - mu[:, None, None]) * invstd[:, None, None]
    f = 1.0 if momentum is None else momentum
    sdy, sdx = dyf.sum(dims), (dyf * xhat).sum(dims)
    dx = (weight * invstd)[:, None, None] * (dyf - (sdy / n)[:, None, None]
                                             - xhat * (sdx / n)[:, None, None])
    return {'y': xhat * weight[:, None, None] + bias[:, None, None], 'dx': dx, 'dw': sdx,
            'db': sdy, 'running_mean': (1 - f) * mean + f * mu,
            'running_var': (1 - f) * var + f * v,
            'scale': {'dw': (dyf * xhat).abs().sum(dims), 'db': dyf.abs().sum(dims)}}


def batch_norm_gaps(got, exact, dtype):
    """Each output's largest gap from the float64 ``exact`` over its
    tolerance: y and dx within one rounding to x's dtype (2^-8 of a bf16
    value, 1e-5 of a float32 one) plus 1e-5 of the largest; the running
    statistics within 1e-5 relative plus 1e-6; dw and db, float32 sums of n
    terms, within 1e-5 of the sum of their terms' magnitudes."""
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    out = {}
    for k in ('y', 'dx'):
        g, w = got[k].double(), exact[k]
        top = float(w.abs().max())
        out[k] = float(((g - w).abs() - rtol * w.abs()).max()) / (1e-5 * top)
    for k in ('running_mean', 'running_var'):
        g, w = got[k].double(), exact[k]
        out[k] = float(((g - w).abs() - 1e-5 * w.abs()).max()) / 1e-6
    for k in ('dw', 'db'):
        out[k] = float(((got[k].double() - exact[k]).abs() / (1e-5 * exact['scale'][k])).max())
    return out


def batch_norm_bytes(b, c, h, w, width, direction):
    """The least bytes a batch norm moves: x read and y written (forward),
    x and dy read and dx written (backward), and the float32 per-channel
    vectors (weight, bias, running and saved statistics; weight, saved
    statistics and both gradients)."""
    n = b * c * h * w
    return (2 * n * width + 8 * c * 4) if direction == 'fwd' else (3 * n * width + 5 * c * 4)


def batch_norm_layouts():
    """Phase 25's two layouts: (label, the wrapper, its forward and backward
    entries, the entries' symbols, the values a thread access, the plan)."""
    from margipose_tpu_torch.ops import batch_norm as bn

    def plan(x, tensors, per):
        b, c, h, w = x.shape
        return bn.plan(c, b * h * w, x.element_size(), tensors, per)

    def plan_nhwc(x, tensors, per):
        b, c, h, w = x.shape
        return bn.plan_nhwc(c, b * h * w, x.element_size(), tensors, per)

    return [('NCHW', bn.batch_norm_train, bn.batch_norm_train_fwd, bn.batch_norm_train_bwd,
             BATCH_NORM_KERNELS[:2], bn.vector_values, plan),
            ('channels-last', bn.batch_norm_train_nhwc, bn.batch_norm_train_nhwc_fwd,
             bn.batch_norm_train_nhwc_bwd, BATCH_NORM_KERNELS[2:], bn.vector_values_nhwc,
             plan_nhwc)]


def batch_norm_phase():
    """The train-mode batch-norm kernels (csrc/batch_norm.cu) on the card,
    the NCHW pair and the channels-last pair, float32 and bf16, at the train
    cells' shapes and three single-value layouts: y, dx, dw, db and the
    running statistics against the float64 computation from the same inputs
    within batch_norm_gaps' tolerances (each excess at most 1), the plain
    version's (torch's batch norm and the running-variance fix-up) gaps
    beside them, momentum None's cumulative average, the launch plan, one
    host launch each way, and the same bits on a second run. The first
    BATCH_NORM_TIMED shapes timed in a CUDA graph against their bytes bound,
    beside the plain forward's eager time and torch's own batch norm
    (F.batch_norm, and ATen's backward, in the same layout) in a graph,
    which the port never calls on the card."""
    from margipose_tpu_torch.ops import batch_norm as bn

    reports = []
    for layout, train, fwd, bwd, symbols, vector_values, plan in batch_norm_layouts():
        for i, (b, c, h, w, offset) in enumerate(BATCH_NORM_SHAPES):
            for dtype in (torch.float32, torch.bfloat16):
                x, dy, params = batch_norm_inputs(b, c, h, w, offset, dtype, seed=100 + i,
                                                  channels_last=layout != 'NCHW')
                name = (f'batch norm {layout} {b}x{c}x{h}x{w}{" +1" if offset else ""} '
                        f'{str(dtype)[6:]}')
                per = vector_values(x)
                plans = [plan(x, t, per) for t in (1, 2)]
                counters = reset_counts(symbols)
                got = batch_norm_run(train, x, dy, params, 0.1)
                torch.cuda.synchronize()
                launches = tuple(read_counts(counters).values())
                again = batch_norm_run(train, x, dy, params, 0.1)
                # the plain version from an aligned copy: cuDNN's channels-last
                # batch norm fails on x off 16-byte alignment
                want = batch_norm_run(bn.batch_norm_train_plain, x.clone(), dy, params, 0.1)
                exact = batch_norm_exact(x, dy, params, 0.1)
                gaps = batch_norm_gaps(got, exact, dtype)
                plain_gaps = batch_norm_gaps(want, exact, dtype)
                same = all(torch.equal(got[k], again[k]) for k in got)
                layout_kept = all(got[k].stride() == x.stride() for k in ('y', 'dx'))
                cumulative = batch_norm_run(train, x, dy, params, None)
                cumulative_want = batch_norm_run(bn.batch_norm_train_plain, x.clone(), dy, params,
                                                 None)
                cgaps = batch_norm_gaps(cumulative, batch_norm_exact(x, dy, params, None), dtype)
                tracked = (int(got['tracked']), int(cumulative['tracked']),
                           int(cumulative_want['tracked']))
                worst = max(max(gaps.values()), cgaps['running_mean'], cgaps['running_var'])
                apart = {k: float((got[k].double() - want[k].double()).abs().max())
                         for k in ('y', 'dx', 'dw', 'db', 'running_mean', 'running_var')}
                phase(name, f'plan fwd {plans[0]}, bwd {plans[1]}, {per} values a thread access; '
                            f'launches {launches}; y and dx in x\'s layout {layout_kept}; gap '
                            'from float64 over tolerance: kernels '
                            + ', '.join(f'{k} {v:.3g}' for k, v in gaps.items())
                            + '; plain version '
                            + ', '.join(f'{k} {v:.3g}' for k, v in plain_gaps.items())
                            + f'; momentum None: running stats {cgaps["running_mean"]:.3g}, '
                              f'{cgaps["running_var"]:.3g}; num_batches_tracked {tracked}; '
                              f'second run bit-equal {same}; kernels vs plain, largest '
                            + ', '.join(f'{k} {v:.3g}' for k, v in apart.items()))
                if not (worst <= 1.0 and launches == (1, 1) and same and layout_kept
                        and tracked == (1, 1, 1)):
                    raise AssertionError(f'{name}: the kernels left the float64 batch norm')
                if i < BATCH_NORM_TIMED:
                    reports.append(batch_norm_times(name, layout, fwd, bwd, x, dy, params, per,
                                                    plans))
                del x, dy, got, again, want, exact, cumulative, cumulative_want
        torch.cuda.empty_cache()
    return reports


def batch_norm_times(name, layout, fwd, bwd, x, dy, params, per, plans):
    """The kernels in a CUDA graph against their bytes bound, the plain
    forward eager, and torch's batch norm in x's layout in a graph."""
    import torch.nn.functional as F

    from margipose_tpu_torch.ops import batch_norm as bn

    b, c, h, w = x.shape
    weight, bias, mean, var = (p.clone() for p in params)
    tracked = torch.zeros((), dtype=torch.long, device='cuda')
    y, save_mean, save_invstd = fwd(x, weight, bias, mean, var, tracked, 0.1, BATCH_NORM_EPS)
    times = {
        'fwd': graph_ms(lambda: fwd(x, weight, bias, mean, var, tracked, 0.1, BATCH_NORM_EPS),
                        samples=10),
        'bwd': graph_ms(lambda: bwd(dy, x, weight, save_mean, save_invstd), samples=10)}
    plain = median_ms(lambda: bn.batch_norm_train_plain(x, weight, bias, mean, var, tracked, 0.1,
                                                        BATCH_NORM_EPS), 3, 5)
    library = {'fwd': graph_ms(lambda: F.batch_norm(x, mean, var, weight, bias, True, 0.1,
                                                    BATCH_NORM_EPS), samples=10)}
    try:
        _, lib_mean, lib_invstd = torch.ops.aten.native_batch_norm(
            x, weight, bias, mean, var, True, 0.1, BATCH_NORM_EPS)
        library['bwd'] = graph_ms(lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, mean, var, lib_mean, lib_invstd, True, BATCH_NORM_EPS,
            [True, True, True]), samples=10)
    except RuntimeError as exc:  # a yardstick only: the port never calls it
        phase(name, f'ATen backward not timed: {exc}')
        library['bwd'] = None
    report = {'name': 'batch_norm_train' if layout == 'NCHW' else 'batch_norm_train_nhwc',
              'layout': layout, 'shape': [b, c, h, w], 'dtype': str(x.dtype)[6:],
              'plan': {'fwd': list(plans[0]), 'bwd': list(plans[1])}, 'values_a_access': per}
    for direction in ('fwd', 'bwd'):
        bound_us = batch_norm_bytes(b, c, h, w, x.element_size(), direction) / HBM_BYTES_PER_S * 1e6
        us = times[direction] * 1e3
        lib = library[direction]
        phase(name, f'{direction}: {us:.2f} us in a CUDA graph, bound {bound_us:.2f} us '
                    f'(bytes), {100 * bound_us / us:.1f}% of it; torch\'s '
                    + (f'{lib * 1e3:.2f} us in a graph' if lib is not None else 'not timed')
                    + (f'; plain forward {plain * 1e3:.2f} us (eager, with the fix-up)'
                       if direction == 'fwd' else ''))
        report[direction] = {'us': us, 'bound_us': bound_us,
                             'library_us': None if lib is None else lib * 1e3}
    report['plain_fwd_us'] = plain * 1e3
    return report


def batch_norm_graph_phase():
    """The train step's batch norms in place, under deterministic cuDNN (no
    timed search, so both sides run the same convolutions): the flagship in
    bf16 and float32, the integral model and Chatterbox in bf16, each
    BATCH_NORM_STEPS steps at batch 32 replayed from the step's CUDA graph
    against the same steps run eagerly, losses, parameters and buffers bit
    for bit; then one replayed and one eager step under a device trace,
    their states still bit-equal: the eager step launches the port's
    forward and backward kernel once a batch norm each, the replay none
    from the host, and neither trace holds an ATen train-mode batch-norm
    kernel."""
    from margipose_tpu_torch.models import (
        Default_Chatterbox_Desc,
        Default_Integral_Desc,
        Default_MargiPose_Desc,
        create_model,
    )
    from margipose_tpu_torch.train.schedules import make_optimiser
    from margipose_tpu_torch.ops import batch_norm as bn
    from margipose_tpu_torch.train.steps import TrainState, eager, make_train_step, step_counts

    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        for label, desc, precision in (('flagship', Default_MargiPose_Desc, 'bfloat16'),
                                       ('flagship', Default_MargiPose_Desc, 'float32'),
                                       ('integral', Default_Integral_Desc, 'bfloat16'),
                                       ('chatterbox', Default_Chatterbox_Desc, 'bfloat16')):
            name = f'batch norm graph {label} {precision}'
            base = create_model(desc, generator=torch.Generator().manual_seed(0)).cuda()
            layers = batch_norm_layers(base.state_dict())
            states, fns, losses = [], [], [[], []]
            for _ in range(2):
                m = copy.deepcopy(base)
                states.append(TrainState(m, make_optimiser('1cycle', m.parameters(), 1.0,
                                                           max_iters=100)))
                fns.append(make_train_step('jsd', precision))
            del base
            for seed in range(BATCH_NORM_STEPS):
                batch = {k: v.cuda() for k, v in flagship_batch(32, seed=80 + seed).items()}
                losses[0].append(fns[0](states[0], batch)['loss'])
                losses[1].append(eager(fns[1], states[1], batch)['loss'])
            got, want = (torch.stack(x).cpu() for x in losses)
            sd = [s.model.state_dict() for s in states]
            differ = [k for k in sd[0] if not torch.equal(sd[0][k], sd[1][k])]
            counts = step_counts(fns[0])
            phase(name, f'{BATCH_NORM_STEPS} graphed steps vs eager: losses {got.tolist()} vs '
                        f'{want.tolist()}, bit-equal {torch.equal(got, want)}; '
                        f'{len(differ)} of {len(sd[0])} state tensors differ {differ[:4]}; '
                        f'counts {counts}')
            if not (torch.equal(got, want) and not differ and counts['replays'] >= 2):
                raise AssertionError(f'{name}: graphed steps left the eager ones')
            batch = {k: v.cuda() for k, v in flagship_batch(32, seed=90).items()}
            traced, host, losses = [], [], []
            # bf16 on one card runs channels-last, float32 NCHW
            cl = precision == 'bfloat16'
            symbols = BATCH_NORM_KERNELS[2:] if cl else BATCH_NORM_KERNELS[:2]
            pair = ('nhwc_fwd', 'nhwc_bwd') if cl else ('fwd', 'bwd')
            for fn in (lambda: fns[0](states[0], batch), lambda: eager(fns[1], states[1], batch)):
                counters = reset_counts(symbols)
                losses.append(on_card(fn)[0]['loss'])
                traced.append(dict(BATCH_NORM_RAN))
                host.append(tuple(read_counts(counters).values()))
            sd = [s.model.state_dict() for s in states]
            differ = [k for k in sd[0] if not torch.equal(sd[0][k], sd[1][k])]
            # the kernels ran iff the states stay bit-equal and the eager step
            # launched each batch norm's two; the traces in this long process
            # have missed one or two forward records (377-378 of 379, states
            # equal), so they are held to no ATen kernel, none of the other
            # layout's and none too many (cuDNN's transposes are reported: its
            # heuristics transpose 3 small convolutions of a full-size
            # channels-last flagship step)
            phase(name, f'one replayed and one eager step: host launches {host[0]} and {host[1]}, '
                        f'batch norm in their traces {traced[0]} and {traced[1]}; then '
                        f'{len(differ)} state tensors differ {differ[:4]}, losses '
                        f'{float(losses[0])} vs {float(losses[1])}')
            if (differ or not torch.equal(losses[0], losses[1])
                    or host != [(0, 0), (layers, layers)]
                    or any(t['aten'] or max(t[k] for k in pair) > layers
                           or sum(t[k] for k in ('fwd', 'bwd', 'nhwc_fwd', 'nhwc_bwd')
                                  if k not in pair)
                           for t in traced)):
                raise AssertionError(f'{name}: a traced step left the other or its kernels')
            del states, fns, sd
            torch.cuda.empty_cache()
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


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
    train_graph_phase(model)
    train_graph_phase(model, 'bfloat16', 'bf16 train graph')
    by_path['infer'] = infer_phase(model)
    by_path['serve'] = serve_phase(ckpt)
    by_path.update(stems_phase())
    by_path.update(chatterbox_phase())
    volumetric = softargmax3d_phase()
    by_path.update(integral_phase())
    batch_norm = batch_norm_phase()
    batch_norm_graph_phase()
    by_path.update(datasets_phase(model, ckpt))
    by_path.update(device_aug_phase(model))
    by_path.update(distributed_phase(model, ckpt))
    by_path.update(cli_phase(model, ckpt))
    by_path.update(tensor_parallel_phase(model, [(1, 1, 'nccl', False), (1, 2, 'gloo', False)]))
    by_path.update(soak_phase())
    for k in kernels:
        # launches: the float32 train path's, which runs both kernels
        k['launches'] = by_path['train'][k['name']]
        k['launches_by_path'] = {path: None if counts is None else counts[k['name']]
                                 for path, counts in by_path.items()}
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'volumetric_kernels': volumetric}), flush=True)
    print(json.dumps({'batch_norm_kernels': batch_norm}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--ddp-worker']:
        sys.exit(ddp_worker(sys.argv[2]))
    if sys.argv[1:2] == ['--tp-worker']:
        sys.exit(tp_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:] == ['--multi-gpu']:
        sys.exit(multi_gpu_main())
    if sys.argv[1:] == ['--soak']:
        sys.exit(soak_main())
    sys.exit(main())
