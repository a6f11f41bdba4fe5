#!/usr/bin/env python3
"""Leslie-Smith LR range test on the card.

Counterpart of ``margipose_tpu/bin/hyperparam_search.py`` (reference:
src/margipose/bin/hyperparam_search.py). Sweeps the learning rate
geometrically from lr_min to lr_max over at most ``max_iters`` train steps
of the port's train step, tracking the EMA-smoothed loss; stops when the
loss diverges to 4x its observed minimum. Writes a loss-vs-lr curve (CSV,
and a PNG where matplotlib is present)::

    python -m margipose_tpu_torch.bin hyperparams with margipose_model synthetic \\
        lr_min=1e-5 lr_max=10
    python -m margipose_tpu_torch.bin.hyperparam_search --device cpu with ...

The model trains in float32 with TF32 off (the JAX bin passes no compute
dtype), its input uploaded as float32. The input size is the model_desc's
(``data_specs_for_desc``: 256 px unless the settings say otherwise).
"""

from __future__ import annotations

import argparse
import datetime
import sys
from os import makedirs, path

import numpy as np
import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.bin.eval_3d import DeviceClock, set_float32_parity_mode
from margipose_tpu_torch.bin.train_3d import device_prefetch
from margipose_tpu_torch.cli import bin_subcommand
from margipose_tpu_torch.config import Experiment
from margipose_tpu_torch.models import (
    Default_Chatterbox_Desc,
    Default_MargiPose_Desc,
    create_model,
    data_specs_for_desc,
)
from margipose_tpu_torch.train.helpers import create_train_dataloader
from margipose_tpu_torch.train.schedules import ScheduledOptimiser
from margipose_tpu_torch.train.steps import TrainState, make_train_step, step_counts
from margipose_tpu_torch.utils import seed_all

ex = Experiment()
ex.add_named_config('margipose_model', model_desc=Default_MargiPose_Desc)
ex.add_named_config('chatterbox_model', model_desc=Default_Chatterbox_Desc)
ex.add_named_config('mpi3d', train_datasets=['mpi3d-train', 'mpii-train'])
ex.add_named_config('h36m', train_datasets=['h36m-trainval', 'mpii-trainval'])
ex.add_named_config('synthetic', train_datasets=['synthetic-512'])

# the JAX bin's defaults (reference: src/margipose/bin/hyperparam_search.py:58-69)
ex.add_config(
    seed=12345,
    model_desc=Default_MargiPose_Desc,
    train_datasets=['mpi3d-train', 'mpii-train'],
    batch_size=32,
    lr_min=1e-1,
    lr_max=1e2,
    max_iters=1000,
    ema_beta=0.99,
    weight_decay=0.0,
    momentum=0.9,
    out_dir='out',
    use_aug=True,
    num_workers=4,
)

READ_BACK_EVERY = 8  # losses read back from the device in groups of this many


class LRCurveAccumulator:
    """EMA smoothing + divergence stop of the Leslie-Smith range test,
    exactly as the reference's search loop applies them (reference:
    src/margipose/bin/hyperparam_search.py:137-148): bias-corrected EMA by
    iteration count, divergence checked against the PREVIOUS minimum
    (guarded on it being positive), and a diverging point neither recorded
    in the curve nor allowed to update the minimum."""

    def __init__(self, beta: float):
        self.beta = beta
        self.avg_loss = 0.0
        self.min_loss = float('inf')
        self.smoothed = []  # recorded curve (excludes the diverging point)
        self.stopped = False

    def add(self, i: int, loss: float) -> bool:
        """Fold in the raw loss of iteration ``i`` (0-based); returns True
        when the sweep should stop (divergence or non-finite loss)."""
        if not np.isfinite(loss):
            self.stopped = True
            return True
        self.avg_loss = self.beta * self.avg_loss + (1 - self.beta) * loss
        smoothed = self.avg_loss / (1 - self.beta ** (i + 1))
        if self.min_loss > 0 and smoothed > 4 * self.min_loss:
            self.stopped = True
            return True
        self.min_loss = min(smoothed, self.min_loss)
        self.smoothed.append(smoothed)
        return False


def sweep_lrs(cfg: dict) -> np.ndarray:
    """The learning rate of each iteration: iteration i trains at
    ``lrs[min(i, max_iters - 1)]``, as the JAX bin's injected schedule reads
    its update count."""
    return np.geomspace(cfg['lr_min'], cfg['lr_max'], cfg['max_iters'])


def make_sweep_optimiser(params, cfg: dict, lrs: np.ndarray) -> ScheduledOptimiser:
    """``torch.optim.SGD``, the reference's optimiser (reference:
    src/margipose/bin/hyperparam_search.py:105): weight decay added to the
    gradient before the momentum buffer. Update ``count`` applies
    ``lrs[count]`` rounded to float32, as the JAX bin's schedule array is."""
    def schedule(count):
        return float(np.float32(lrs[min(count, len(lrs) - 1)])), cfg['momentum']

    return ScheduledOptimiser(
        torch.optim.SGD(params, lr=float(np.float32(lrs[0])), momentum=cfg['momentum'],
                        weight_decay=cfg['weight_decay']), schedule)


def run_lr_range_test(cfg: dict, device='cuda', model=None) -> dict:
    """The sweep: ``{lrs, losses}`` of the recorded points (the lr each
    iteration trained at, its smoothed loss) and ``step_seconds``, each
    iteration's time on the device (CUDA events on the card, the host clock
    on the CPU), and ``step_counts``, the train step's eager, captured and
    replayed steps (``train.steps.step_counts``). ``model`` replaces the
    seeded initial model (a test starts from carried weights)."""
    device = resolve_device(device)
    seed_all(cfg['seed'])
    set_float32_parity_mode()
    if model is None:
        model = create_model(cfg['model_desc'],
                             generator=torch.Generator().manual_seed(cfg['seed']))
    model.to(device)
    data_specs = data_specs_for_desc(cfg['model_desc'])

    loader = create_train_dataloader(
        cfg['train_datasets'], data_specs, cfg['batch_size'],
        cfg['max_iters'] * cfg['batch_size'], cfg['use_aug'],
        num_workers=cfg['num_workers'], seed=cfg['seed'])

    lrs = sweep_lrs(cfg)
    state = TrainState(model, make_sweep_optimiser(model.parameters(), cfg, lrs))
    train_step = make_train_step(cfg['model_desc']['settings'].get('pixelwise_loss', 'jsd'),
                                 torch.float32)

    used_lrs = []
    curve = LRCurveAccumulator(cfg['ema_beta'])
    losses = curve.smoothed
    clock = DeviceClock(device)
    marks = []

    # Losses stay on the device and are read back in groups, so the host
    # waits for the device once a group: the divergence check lags by at
    # most READ_BACK_EVERY - 1 iterations.
    pending = []
    drained_upto = 0  # iteration index of the first un-drained loss
    stop = False

    def process_pending():
        nonlocal stop, drained_upto
        vals = torch.stack(pending).cpu().numpy()
        pending.clear()
        base_i = drained_upto
        drained_upto += len(vals)
        for k, loss in enumerate(vals):
            i = base_i + k
            loss = float(loss)
            if curve.add(i, loss):
                reason = ('non-finite loss' if not np.isfinite(loss) else
                          f'loss diverged (> 4x {curve.min_loss:.4g})')
                print(f'stopping at iter {i}: {reason}')
                stop = True
                return
            used_lrs.append(float(lrs[i]))
            if i % 25 == 0:
                print(f'iter {i:4d}  lr={lrs[i]:.3e}  '
                      f'loss={curve.smoothed[-1]:.5f}', flush=True)

    for i, (_, device_batch) in enumerate(device_prefetch(loader, device)):
        if i >= cfg['max_iters'] or stop:
            break
        start = clock.mark()
        metrics = train_step(state, device_batch)
        marks.append((start, clock.mark()))
        pending.append(metrics['loss'])
        if len(pending) >= READ_BACK_EVERY:
            process_pending()
    if pending and not stop:
        process_pending()
    if marks:
        clock.wait(marks[-1][1])

    out = {'lrs': used_lrs, 'losses': losses,
           'step_seconds': [clock.seconds(s, e) for s, e in marks],
           'step_counts': step_counts(train_step)}
    if out['step_seconds']:
        what = 'device (CUDA events)' if device.type == 'cuda' else 'host clock'
        print(f'{len(marks)} iterations, ms each on the {what}: '
              + ', '.join(f'{s * 1e3:.3f}' for s in out['step_seconds']))
    if cfg['out_dir']:
        exp_dir = path.join(
            cfg['out_dir'],
            'lrfind-' + datetime.datetime.now().strftime('%Y%m%d-%H%M%S'))
        makedirs(exp_dir, exist_ok=True)
        np.savetxt(path.join(exp_dir, 'lr_curve.csv'),
                   np.stack([used_lrs, losses], 1), delimiter=',',
                   header='lr,loss')
        out['exp_dir'] = exp_dir
        print(f'wrote {exp_dir}/lr_curve.csv')
        try:
            import matplotlib

            matplotlib.use('Agg')
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
            ax.plot(used_lrs, losses)
            ax.set_xscale('log')
            ax.set_xlabel('learning rate')
            ax.set_ylabel('smoothed loss')
            fig.savefig(path.join(exp_dir, 'lr_curve.png'), dpi=100)
            plt.close(fig)
            print(f'wrote {exp_dir}/lr_curve.png')
        except Exception as e:  # plotting is best-effort
            print(f'plotting failed: {e}')
    return out


def parse_args(argv):
    """(``--device``, the ``with ...`` config words)."""
    parser = argparse.ArgumentParser(
        prog='margipose-torch-hyperparams', description='learning-rate range test',
        usage='%(prog)s [--device DEVICE] with NAMED_CONFIG... KEY=VALUE...')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' runs the plain paths on the host")
    return parser.parse_known_args(argv)


def main(argv=None):
    args, rest = parse_args(sys.argv[1:] if argv is None else argv)
    return run_lr_range_test(ex.parse(rest), device=args.device)


Hyperparams_Subcommand = bin_subcommand('hyperparams', main, help='run hyperparameter search')

if __name__ == '__main__':
    main()
