#!/usr/bin/env python3
"""Train a 3D pose model on the card.

Counterpart of ``margipose_tpu/bin/train_3d.py`` (reference:
src/margipose/bin/train_3d.py): bf16 autocast on the card and float32 on
the CPU unless ``precision`` says otherwise, the input uploaded as uint8
unless ``ship='float32'``, or, with ``device_aug=True``, the raw uint8 frames
uploaded with each example's affine and colour parameters and augmented on
the device (``device_aug_canvas=N``: crop-ship onto an NxN canvas). Usage
mirrors the reference preset names::

    python -m margipose_tpu_torch.bin.train_3d with margipose_model synthetic \\
        epochs=2 batch_size=8
    python -m margipose_tpu_torch.bin.train_3d --device cpu with margipose_model \\
        synthetic quick

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N -m
margipose_tpu_torch.bin.train_3d ...``) each process trains on
``cuda:LOCAL_RANK`` (gloo on the CPU) with DistributedDataParallel:
``batch_size`` is the global batch, each process loads its share with its
own loader seed, batch-norm statistics and the loss span the global batch,
and process 0 writes the metrics, the config, the traces and the
checkpoints.

Each step's loss and predictions stay on the device; they are read back once
per ``metrics_every`` window. A checkpoint of the full train state goes to
``<out_dir>/<experiment_id>/model-latest`` after every ``checkpoint_every``
epochs, in the background; ``margipose_tpu_torch.bin.eval_3d --model`` reads
it.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import json
import sys
import time
import traceback
from os import makedirs, path

import numpy as np
import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.bin.eval_3d import DeviceClock, set_float32_parity_mode
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.cli import bin_subcommand
from margipose_tpu_torch.config import Experiment
from margipose_tpu_torch.data.loader import DEVICE_FIELDS
from margipose_tpu_torch.data.mpi_inf_3dhp import MpiInf3dDataset
from margipose_tpu_torch.data.specs import device_input, to_device
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.models import (
    Default_Chatterbox_Desc,
    Default_MargiPose_Desc,
    create_model,
    data_specs_for_desc,
)
from margipose_tpu_torch.ops.image import device_augment
from margipose_tpu_torch.parallel import mesh
from margipose_tpu_torch.parallel.precision import resolve_dtype
from margipose_tpu_torch.train import checkpoint as ckpt
from margipose_tpu_torch.train.helpers import (
    create_train_dataloader,
    create_val_dataloader,
    save_image_grid,
    visualise_predictions,
)
from margipose_tpu_torch.train.meters import make_train_reporter, timer
from margipose_tpu_torch.train.pretrained import load_pretrained_stem
from margipose_tpu_torch.train.schedules import make_optimiser, schedule_values
from margipose_tpu_torch.train.steps import (
    TrainState,
    make_eval_step,
    make_train_step,
    step_counts,
)
from margipose_tpu_torch.utils import init_algorithms, seed_all

ex = Experiment()

# Model presets (reference: src/margipose/bin/train_3d.py:230-231)
ex.add_named_config('margipose_model', model_desc=Default_MargiPose_Desc)
ex.add_named_config('chatterbox_model', model_desc=Default_Chatterbox_Desc)

# Optimiser presets (reference: src/margipose/bin/train_3d.py:234-239)
ex.add_named_config('rmsprop', optim_algorithm='rmsprop', epochs=150, lr=2.5e-3,
                    lr_milestones=[80, 140], lr_gamma=0.1)
ex.add_named_config('1cycle', optim_algorithm='1cycle', epochs=150, lr=1.0,
                    lr_milestones=None, lr_gamma=None)
ex.add_named_config('sgd_simple', optim_algorithm='sgd_simple', epochs=150, lr=0.2,
                    lr_milestones=None, lr_gamma=None)

# Dataset presets (reference: src/margipose/bin/train_3d.py:242-243)
ex.add_named_config('mpi3d', train_datasets=['mpi3d-trainval', 'mpii-trainval'],
                    val_datasets=[])
ex.add_named_config('h36m', train_datasets=['h36m-trainval', 'mpii-trainval'],
                    val_datasets=[])
ex.add_named_config('synthetic', train_datasets=['synthetic-512'],
                    val_datasets=['synthetic-64@1'])

# Debug preset (reference: src/margipose/bin/train_3d.py:246-247)
ex.add_named_config('quick', out_dir='', epochs=10, tags=['quick'], quick=True,
                    train_examples=256, val_examples=128)

ex.add_config(
    seed=12345,
    model_desc=Default_MargiPose_Desc,
    optim_algorithm='1cycle', epochs=150, lr=1.0, lr_milestones=None, lr_gamma=None,
    train_datasets=['mpi3d-trainval', 'mpii-trainval'], val_datasets=[],
    out_dir='out',
    batch_size=32,
    tags=[],
    quick=False,
    experiment_id=None,
    weights=None,             # warm-start model weights only (reference semantics)
    pretrained_stem=None,     # ImageNet backbone .pth for the in_cnn stem
                              # (pretrainedmodels inceptionv4 / torchvision
                              # resnet18/34/50 format); fresh runs only
    resume=None,              # checkpoint dir: restore the FULL train state
                              # (weights, optimiser, step, epoch) and continue
    deterministic=False,      # cuDNN deterministic algorithms (utils.init_algorithms)
    train_examples=32000,
    val_examples=1600,
    use_aug=True,
    preserve_root_joint_at_univ_scale=False,
    num_workers=4,
    metrics_every=10,         # batches between host-side mpjpe/pck evals
    checkpoint_every=1,       # epochs between checkpoint saves
    precision=None,           # compute dtype: 'float32' (TF32 off, the parity
                              # mode) or 'bfloat16' (autocast; float32 weights,
                              # optimiser state and BN stats). None: bfloat16
                              # on the card, float32 on the CPU
    profile_steps=0,          # >0: torch.profiler trace of that many batches of
                              # epoch 0 to <out_dir>/<id>/profile/trace.json
    device_aug=False,         # ship raw uint8 frames + affine/colour params and
                              # augment on the device (ops/image.device_augment)
    device_aug_canvas=0,      # device_aug: 0 ships full frames on the sources'
                              # largest fixed raw size (else 768x768); N>0
                              # crop-ships each example's source region
                              # letterboxed onto an NxN canvas
    prefetch_depth=2,         # batches uploaded ahead of the step that uses them
    ship='uint8',             # host->device input encoding: 'uint8' requantises
                              # the input to its exact source pixels (lossless,
                              # 4x fewer bytes) and renormalises on the device,
                              # which differs from the host's normalisation at
                              # the last ulp; 'float32' uploads the host tensor.
                              # 'uint8' under either precision, as in JAX
                              # (eval's --ship auto keeps float32 for float32).
                              # Ignored under device_aug (raw frames ship as
                              # uint8)
)

# dtype of each uploaded field but the input (data/loader.DEVICE_FIELDS)
_FIELD_DTYPES = {'target': np.float32, 'joint_mask': np.float32, 'valid_depth': np.int64,
                 'raw_image': np.uint8, 'aug_affine': np.float32, 'aug_colour': np.float32}


def device_prefetch(loader, device, depth=2, ship_specs=None):
    """(host batch, device batch) pairs, each upload enqueued up to ``depth``
    - 1 batches ahead of the step that uses it. The device batch holds the
    batch's ``DEVICE_FIELDS``: the input as NCHW float32 (with ``ship_specs``,
    an ``ImageSpecs``, it goes up as uint8 pixels and is renormalised on the
    device), the target, joint mask and valid_depth, and under device
    augmentation the raw uint8 NHWC frames, the [B,3,3] affines and the
    [B,4] colour parameters in place of the input."""
    queue = collections.deque()
    for batch in loader:
        uploaded = {}
        for key in DEVICE_FIELDS:
            if key not in batch:
                continue
            if key == 'input':
                uploaded[key] = device_input(batch[key], device, ship_specs)
            else:
                uploaded[key] = to_device(
                    np.ascontiguousarray(batch[key], _FIELD_DTYPES[key]), device)
        queue.append((batch, uploaded))
        if len(queue) >= max(depth, 1):
            yield queue.popleft()
    yield from queue


def make_aug_step(input_specs):
    """``aug_step(raw, affine, colour)``: raw uint8 [B,H,W,3] frames -> the
    normalised NCHW float32 model input, warped by each example's affine to
    the input size and colour-jittered (``ops/image.device_augment``), as the
    JAX bin's jitted ``aug_step``."""
    h, w = input_specs.height, input_specs.width
    mean = tuple(input_specs.mean) if input_specs.mean is not None else (0., 0., 0.)
    std = tuple(input_specs.stddev) if input_specs.stddev is not None else (1., 1., 1.)

    def aug_step(raw, affine, colour):
        x = raw.to(torch.float32) / 255.0
        x = device_augment(x, affine, h, w, colour[:, 0], colour[:, 1], colour[:, 2],
                           colour[:, 3], mean, std)
        return x.permute(0, 3, 1, 2).contiguous()

    return aug_step


def run_training(cfg: dict, device='cuda') -> dict:
    device = resolve_device(device)
    cfg = dict(cfg)
    if cfg['precision'] is None:
        cfg['precision'] = 'bfloat16' if device.type == 'cuda' else 'float32'
    compute_dtype = resolve_dtype(cfg['precision'])
    if cfg['ship'] not in ('uint8', 'float32'):
        raise ValueError(f"ship={cfg['ship']!r}; expected 'uint8' or 'float32'")
    seed_all(cfg['seed'])
    init_algorithms(deterministic=cfg['deterministic'])
    if compute_dtype == torch.float32:
        set_float32_parity_mode()
    upload = ('raw uint8 frames, augmented on the device' if cfg['device_aug']
              else cfg['ship'])
    print(f"Precision: {cfg['precision']}; input upload: {upload}")

    experiment_id = cfg['experiment_id'] or datetime.datetime.now().strftime('%Y%m%d-%H%M%S%f')
    if not cfg['experiment_id']:
        # every process writes (or waits on) one directory: process 0's
        experiment_id = mesh.broadcast_object(experiment_id)
    exp_out_dir = None
    if cfg['out_dir']:
        exp_out_dir = path.join(cfg['out_dir'], experiment_id)
        makedirs(exp_out_dir, exist_ok=True)
    print(f'Experiment ID: {experiment_id}')

    # ---- Model ----
    model_desc = cfg['model_desc']
    init_weights = None
    resume_meta = None
    if cfg['resume'] is not None:
        # Full-state resume, fixing the reference's asymmetry of saving but
        # never restoring optimiser state and epoch
        # (reference: src/margipose/bin/train_3d.py:285-291,374-382).
        resume_meta = ckpt.load_meta(cfg['resume'])
        model_desc = resume_meta['model_desc']
    elif cfg['weights'] is not None:
        init_model, model_desc = load_model(cfg['weights'], 'cpu')  # copied below
        init_weights = init_model.state_dict()
    model = create_model(model_desc, generator=torch.Generator().manual_seed(cfg['seed']))
    if init_weights is not None:
        model.load_state_dict(init_weights, strict=True)
    elif cfg['pretrained_stem'] and cfg['resume'] is None:
        # as the JAX bin: the settings' feature extractor, inceptionv4 where
        # there is none (Chatterbox), whose blocks then match no key and raise
        feature_extractor = model_desc['settings'].get('feature_extractor', 'inceptionv4')
        load_pretrained_stem(model, cfg['pretrained_stem'], feature_extractor)
        print(f"initialised {feature_extractor} stem from {cfg['pretrained_stem']}")
    model.to(device)
    print(json.dumps(model_desc, sort_keys=True, indent=2))

    # ---- Data ----
    MpiInf3dDataset.preserve_root_joint_at_univ_scale = \
        cfg['preserve_root_joint_at_univ_scale']
    data_specs = data_specs_for_desc(model_desc)
    # under device_aug the frames ship as raw uint8 already
    ship_specs = (data_specs.input_specs
                  if cfg['ship'] == 'uint8' and not cfg['device_aug'] else None)
    aug_step = make_aug_step(data_specs.input_specs) if cfg['device_aug'] else None
    # each process loads batch_size / process_count rows with its own seed
    n_proc = mesh.process_count()
    assert cfg['batch_size'] % n_proc == 0, (
        f"batch_size {cfg['batch_size']} must divide over {n_proc} processes")
    local_batch = cfg['batch_size'] // n_proc
    loader_seed = cfg['seed'] + 1021 * mesh.process_index()
    train_loader = create_train_dataloader(
        cfg['train_datasets'], data_specs, local_batch, cfg['train_examples'] // n_proc,
        cfg['use_aug'], num_workers=cfg['num_workers'], seed=loader_seed,
        device_aug=cfg['device_aug'], device_aug_canvas=cfg['device_aug_canvas'])
    val_loader = None
    if cfg['val_datasets']:
        val_loader = create_val_dataloader(
            cfg['val_datasets'], data_specs, local_batch, cfg['val_examples'] // n_proc,
            num_workers=cfg['num_workers'], seed=loader_seed)

    # ---- Optimiser ----
    steps_per_epoch = len(train_loader)
    max_iters = cfg['epochs'] * steps_per_epoch
    schedule_args = dict(max_iters=max_iters, milestones=cfg['lr_milestones'],
                         gamma=cfg['lr_gamma'], steps_per_epoch=steps_per_epoch)
    optimiser = make_optimiser(cfg['optim_algorithm'], model.parameters(), cfg['lr'],
                               **schedule_args)
    state = TrainState(model, optimiser)
    if cfg['resume'] is not None:
        ckpt.restore_checkpoint(cfg['resume'], state)
    pixelwise_loss = model_desc['settings'].get('pixelwise_loss', 'jsd')
    train_step = make_train_step(pixelwise_loss, compute_dtype)
    eval_step = make_eval_step(pixelwise_loss, compute_dtype) if val_loader else None

    # ---- Reporting ----
    # every process shares exp_out_dir (checkpoint saves are collective), but
    # the file sinks, config.json, traces and image grids are process 0's
    file_out_dir = exp_out_dir if mesh.process_index() == 0 else None
    tel = make_train_reporter(with_val=val_loader is not None, out_dir=file_out_dir)
    if file_out_dir:
        with open(path.join(file_out_dir, 'config.json'), 'w') as f:
            json.dump(cfg, f, indent=2, sort_keys=True, default=str)

    start_epoch = int(resume_meta.get('epoch', 0)) if resume_meta else 0
    if start_epoch:
        print(f'Resuming from epoch {start_epoch} (step {state.step})')

    result = {}
    save_thread = None
    try:
        for epoch in range(start_epoch, cfg['epochs']):
            tel.epoch = epoch  # keep sink labels aligned when resuming
            tel['epoch'].set_value(epoch)
            print(f'> Epoch {epoch + 1:3d}/{cfg["epochs"]:3d}', flush=True)
            # pin per-example augmentation ordinals to the true epoch so a
            # resumed run draws what an uninterrupted one would
            train_loader.set_epoch(epoch)
            if val_loader is not None:
                val_loader.set_epoch(epoch)

            step_seconds = do_training_pass(cfg, state, train_step, tel, train_loader, device,
                                            file_out_dir, ship_specs, aug_step)
            if val_loader is not None:
                do_validation_pass(cfg, state, eval_step, tel, val_loader, device, ship_specs)

            # the schedule values the epoch's LAST update applied (update N
            # reads the counter at N-1)
            lr_now, mom_now = schedule_values(cfg['optim_algorithm'], cfg['lr'],
                                              max(state.step - 1, 0), **schedule_args)
            tel['lr'].set_value(lr_now)
            tel['momentum'].set_value(mom_now)

            result = {k: tel[k].value() for k in (
                'train_pck', 'train_mpjpe', 'train_loss', 'step_time', 'train_images_per_sec',
                'data_load_time')}
            result['step_seconds'] = step_seconds
            if exp_out_dir and (epoch + 1) % cfg['checkpoint_every'] == 0:
                if save_thread is not None:
                    save_thread.join()  # one in-flight save per directory
                save_thread = ckpt.save_checkpoint(
                    path.join(exp_out_dir, 'model-latest'), state, model_desc,
                    extra={'epoch': epoch + 1, 'train_datasets': cfg['train_datasets']},
                    background=True)
            tel.step()
    except BaseException:
        _join_final_save(save_thread, in_flight=True)
        raise
    _join_final_save(save_thread, in_flight=False)

    result['experiment_id'] = experiment_id
    result['step'] = state.step
    result['step_counts'] = step_counts(train_step)
    return result


def _join_final_save(save_thread, *, in_flight):
    """Join the last background checkpoint save. A failed save must not
    replace a training exception that is propagating (``join()`` re-raises):
    the training error is what the user needs to see. With no exception
    propagating, the save failure is the error, and is re-raised.

    The caller passes ``in_flight`` from its except/else structure:
    ``sys.exc_info()`` cannot tell the training loop's own exception from one
    handled in an enclosing frame."""
    if save_thread is None:
        return
    try:
        save_thread.join()
    # BaseException: join() re-raises whatever the save thread caught, which
    # may be SystemExit; that too defers to a training error in flight.
    except BaseException:
        if not in_flight:
            raise
        traceback.print_exc()
        print('warning: background checkpoint save failed (traceback above); '
              'the original training error follows', file=sys.stderr, flush=True)


def _host_metrics(batch, dataset, host_preds, tel, prefix):
    norm_preds = ensure_homogeneous(np.asarray(host_preds, np.float64), d=3)
    for m in dataset.evaluate_3d_batch(batch, norm_preds):
        tel[f'{prefix}_mpjpe'].add(m['mpjpe'])
        tel[f'{prefix}_pck'].add(m['pck'])


def do_training_pass(cfg, state, train_step, tel, loader, device, exp_out_dir,
                     ship_specs=None, aug_step=None):
    """One epoch of train steps. Returns each step's seconds on the device
    (CUDA events on the card, the host clock on the CPU).

    Reading a loss back every step would make the host wait for the device
    each step, so losses stay on the device and are read back in one copy
    every ``metrics_every`` steps. step_time and train_images_per_sec are
    window averages with data-load stalls subtracted; the first window
    (cuDNN's algorithm search) is left out of the timing meters."""
    vis_done = False
    clock = DeviceClock(device)
    step_marks = []
    batch_iter = device_prefetch(loader, device, cfg['prefetch_depth'], ship_specs)
    profiler = None
    if cfg['profile_steps'] and exp_out_dir and state.step == 0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    pending_losses = []
    window_t0 = time.perf_counter()
    window_images = 0
    window_load_s = 0.0
    first_window = True

    def drain_window():
        nonlocal window_t0, window_images, window_load_s, first_window
        if not pending_losses:
            return
        losses = torch.stack(pending_losses).cpu().numpy()  # one read-back
        dt = time.perf_counter() - window_t0 - window_load_s
        # weighted by window length: the epoch value is the mean over batches
        # (reference: src/margipose/bin/train_3d.py:167), and windows are ragged
        tel['train_loss'].add(float(losses.mean()), len(losses))
        if not first_window:
            # step_time is total time over total steps; images_per_sec,
            # weighted by duration, is total images over total time
            tel['step_time'].add(dt / len(pending_losses), len(pending_losses))
            tel['train_images_per_sec'].add(window_images / max(dt, 1e-9), max(dt, 1e-9))
        first_window = False
        pending_losses.clear()
        window_t0 = time.perf_counter()
        window_images = 0
        window_load_s = 0.0

    i = 0
    while True:
        t_load = time.perf_counter()
        item = next(batch_iter, None)
        load_s = time.perf_counter() - t_load
        if item is None:
            break
        batch, device_batch = item
        if aug_step is not None:
            device_batch['input'] = aug_step(device_batch.pop('raw_image'),
                                             device_batch.pop('aug_affine'),
                                             device_batch.pop('aug_colour'))
        tel['data_load_time'].add(load_s)
        window_load_s += load_s
        start = clock.mark()
        metrics = train_step(state, device_batch)
        step_marks.append((start, clock.mark()))
        pending_losses.append(metrics['loss'])
        window_images += len(batch['valid_depth'])

        if i % cfg['metrics_every'] == 0:
            drain_window()  # before the host metrics: keep them out of step_time
            with timer(tel['eval_time']):
                host_preds = metrics['pred'].cpu().numpy()
                _host_metrics(batch, loader.dataset, host_preds, tel, 'train')
            if not vis_done and exp_out_dir:
                if aug_step is not None:  # the input exists on the device only
                    batch = dict(batch, input=device_batch['input'].permute(0, 2, 3, 1).cpu()
                                 .numpy())
                images = visualise_predictions(host_preds, batch, loader.dataset)
                save_image_grid(images, path.join(exp_out_dir, 'train_examples.png'))
                vis_done = True
            window_t0 = time.perf_counter()  # restart after host work
        i += 1
        if profiler is not None and i >= cfg['profile_steps']:
            _stop_profiler(profiler, device, exp_out_dir)
            profiler = None
    drain_window()
    if profiler is not None:
        _stop_profiler(profiler, device, exp_out_dir)
    if step_marks:
        clock.wait(step_marks[-1][1])
    return [clock.seconds(s, e) for s, e in step_marks]


def _stop_profiler(profiler, device, exp_out_dir):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    profiler.stop()
    out = path.join(exp_out_dir, 'profile')
    makedirs(out, exist_ok=True)
    profiler.export_chrome_trace(path.join(out, 'trace.json'))


def do_validation_pass(cfg, state, eval_step, tel, loader, device, ship_specs=None):
    """Validation epoch with windowed read-backs: eval steps are enqueued
    back to back, and each ``metrics_every``-batch window of losses and
    predictions comes back in two copies. Host metrics score every example
    (reference: src/margipose/bin/train_3d.py:199-226 reads every batch)."""
    pending = []  # (loss, pred, host batch) of the open window

    def drain_window():
        if not pending:
            return
        losses = torch.stack([loss for loss, _, _ in pending]).cpu().numpy()
        preds = torch.stack([pred for _, pred, _ in pending]).cpu().numpy()
        for loss in losses:
            tel['val_loss'].add(float(loss))
        for (_, _, batch), host_preds in zip(pending, preds):
            _host_metrics(batch, loader.dataset, host_preds, tel, 'val')
        pending.clear()

    for batch, device_batch in device_prefetch(loader, device, cfg['prefetch_depth'],
                                               ship_specs):
        metrics = eval_step(state.model, device_batch)
        # keep only the host fields the metrics need, not the input images
        host_batch = {k: batch[k] for k in ('index', 'original_skel', 'camera_intrinsic',
                                            'transform_opts', 'valid_depth')}
        pending.append((metrics['loss'], metrics['pred'], host_batch))
        if len(pending) >= cfg['metrics_every']:
            drain_window()
    drain_window()


def parse_args(argv):
    """(``--device``, the ``with ...`` config words)."""
    parser = argparse.ArgumentParser(
        prog='margipose-torch-train', description='train a 3D pose model',
        usage='%(prog)s [--device DEVICE] with NAMED_CONFIG... KEY=VALUE...')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' runs the plain paths on the host")
    return parser.parse_known_args(argv)


def main(argv=None):
    """Parse the arguments and train. Launched by torchrun, the process
    joins the process group of torchrun's environment first and leaves it
    at the end."""
    args, rest = parse_args(sys.argv[1:] if argv is None else argv)
    cfg = ex.parse(rest)
    joined = not mesh.group_active()
    device = mesh.init_from_env(resolve_device(args.device))
    try:
        return run_training(cfg, device=device)
    finally:
        if joined:
            mesh.shutdown()


Train_Subcommand = bin_subcommand('train', main, help='train a model')


if __name__ == '__main__':
    main()
