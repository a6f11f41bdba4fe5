"""One training process of a soak: the train bin, then an eval of the live
train state, in one process the soak's runner (``soak/run.py``) may SIGKILL.

    python -m margipose_tpu_torch.soak.child --record FILE --eval-dataset DS \\
        --eval-batch-size N [--pause-in-save EPOCH] [--device cuda] -- WORDS...

It trains through ``bin.train_3d.main`` (``WORDS`` are the config words
after ``with``), counting both kernels' launches from 0, and then evaluates
the train state it holds, in float32 as ``bin.eval_3d`` does, without
reading the saved weights. ``--record`` gets one JSON object: the device, the steps
this process ran, the launches, every step's device seconds, each save's
synchronous host copy and background write-and-swap, and the eval's
per-example metrics and mean loss, which ``soak/verify.py`` holds a fresh
process's ``bin.eval_3d`` on the saved checkpoint to.

The train bin keeps its state to itself, so the process observes it where
the bin hands it on: ``train_3d.do_training_pass`` gets the state each
epoch, ``train.checkpoint.save_checkpoint`` and ``_write_and_swap`` save it.
With ``--pause-in-save k``, the save of epoch k stops halfway through its
swap (the old ``state`` renamed to ``state.old``, the new one still
``state.next``), writes ``<record>.paused`` and sleeps, for the runner to
SIGKILL it there: a crash in the one window where only ``state.old`` holds
the last good checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


class _Probe:
    """Wraps the three train-bin functions the process observes; ``undo``
    puts them back."""

    def __init__(self, pause_in_save=None, marker=None):
        from margipose_tpu_torch.bin import train_3d
        from margipose_tpu_torch.train import checkpoint

        self.state, self.start_step = None, None
        self.step_seconds, self.copy_seconds, self.write_seconds = [], [], []
        real = {'pass': train_3d.do_training_pass, 'save': checkpoint.save_checkpoint,
                'swap': checkpoint._write_and_swap}

        def training_pass(cfg, state, *args, **kwargs):
            if self.state is None:
                self.state, self.start_step = state, state.step
            seconds = real['pass'](cfg, state, *args, **kwargs)
            self.step_seconds += seconds
            return seconds

        def save(*args, **kwargs):
            t0 = time.perf_counter()
            thread = real['save'](*args, **kwargs)
            self.copy_seconds.append(time.perf_counter() - t0)
            return thread

        def swap(ckpt_dir, payload, meta):
            t0 = time.perf_counter()
            if meta.get('epoch') == pause_in_save:
                _swap_then_pause(real['swap'], ckpt_dir, payload, meta, marker)  # no return
            real['swap'](ckpt_dir, payload, meta)
            self.write_seconds.append(time.perf_counter() - t0)

        train_3d.do_training_pass = training_pass
        checkpoint.save_checkpoint, checkpoint._write_and_swap = save, swap

        def undo():
            train_3d.do_training_pass = real['pass']
            checkpoint.save_checkpoint, checkpoint._write_and_swap = real['save'], real['swap']

        self.undo = undo


def _swap_then_pause(write_and_swap, ckpt_dir, payload, meta, marker):
    """``write_and_swap`` up to its rename of ``state`` to ``state.old``;
    then ``marker`` is written and the thread sleeps until the process is
    killed."""
    real_rename = os.rename

    def rename(src, dst):
        real_rename(src, dst)
        if dst.endswith('state.old'):
            with open(marker, 'w') as f:
                f.write(str(meta['epoch']))
            while True:
                time.sleep(60)

    os.rename = rename
    write_and_swap(ckpt_dir, payload, meta)


def run(words, device, eval_dataset, eval_batch_size, pause_in_save=None, marker=None):
    """Train on ``words``, then evaluate the live state; returns the record."""
    from margipose_tpu_torch.bin import eval_3d, train_3d
    from margipose_tpu_torch.ops import launch_counts, zero_launch_counts
    from margipose_tpu_torch.train.checkpoint import load_meta

    kernels = ('dsnt_jsd_fwd', 'dsnt_jsd_bwd')
    probe = _Probe(pause_in_save, marker)
    zero_launch_counts(*kernels)
    t0 = time.perf_counter()
    try:
        result = train_3d.main(['--device', device, 'with', *words])
    finally:
        probe.undo()
    wall = time.perf_counter() - t0
    launches = launch_counts(*kernels)
    ckpt_dir = os.path.join(_out_dir(words), result['experiment_id'], 'model-latest')
    model_desc = load_meta(ckpt_dir)['model_desc']  # the description, not the weights
    argv = ['--model', ckpt_dir, '--dataset', eval_dataset, '--batch-size',
            str(eval_batch_size), '--precision', 'float32', '--device', device]
    zero_launch_counts(*kernels)
    rows, stats = eval_3d.main(argv, model=(probe.state.model, model_desc))
    dev = torch.device(device)
    return {'device': str(dev),
            'device_name': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
            'start_step': probe.start_step, 'step': result['step'],
            'launches': launches, 'step_counts': result['step_counts'], 'wall_seconds': wall,
            'step_seconds': probe.step_seconds, 'save_copy_seconds': probe.copy_seconds,
            'save_write_seconds': probe.write_seconds,
            'eval': {'argv': argv, 'rows': {m: [float(v) for v in rows[m]]
                                            for m in eval_3d.METRICS},
                     'mean_loss': float(stats['mean_loss']),
                     'launches': launch_counts(*kernels)}}


def _out_dir(words):
    for word in reversed(words):
        if word.startswith('out_dir='):
            return word.partition('=')[2]
    raise ValueError('a soak run names its out_dir')


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index('--')
    parser = argparse.ArgumentParser(prog='python -m margipose_tpu_torch.soak.child')
    parser.add_argument('--record', required=True)
    parser.add_argument('--eval-dataset', required=True)
    parser.add_argument('--eval-batch-size', type=int, required=True)
    parser.add_argument('--pause-in-save', type=int, default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv[:split])
    record = run(argv[split + 1:], args.device, args.eval_dataset, args.eval_batch_size,
                 args.pause_in_save, args.record + '.paused')
    tmp = args.record + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(record, f)
    os.replace(tmp, args.record)
    return 0


if __name__ == '__main__':
    sys.exit(main())
