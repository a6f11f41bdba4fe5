"""Planted faults the soak verifier must catch (``chip_smoke.py`` phase 23
and ``tests/test_torch_soak.py``). Each writes a copy of a soak's
experiment directory into ``out_dir`` and returns the copy's path; the
original is left as it was. ``CAUGHT_BY`` names the check that must FAIL on
each.
"""

from __future__ import annotations

import json
import shutil
from os import path

import torch

from margipose_tpu_torch.soak import run
from margipose_tpu_torch.train import checkpoint as ckpt

CAUGHT_BY = {
    'count': 'optimiser update count and train step == T updates',
    'batch_norm': "bin.eval_3d in a fresh process == the training process's eval of its live "
                  'state',
    'missing_epoch': 'all epochs recorded',
}


def _copy(exp_dir, out_dir):
    dst = path.join(out_dir, path.basename(exp_dir.removesuffix('.killed')))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(exp_dir, dst)
    return dst


def _edit_payload(exp_dir, edit):
    state_file = ckpt._state_file(path.join(exp_dir, 'model-latest'))  # state, or state.old
    payload = torch.load(state_file, map_location='cpu', weights_only=True)
    edit(payload)
    torch.save(payload, state_file)


def count_off_by_one(killed_dir, out_dir, name, dataset, device, overrides=(), timeout=3600):
    """A resumed run whose restored optimiser ``count`` is one update short:
    the directory a kill left (``run_recipe(keep_killed=True)``), its
    checkpoint's count decremented, resumed to the end."""
    exp_dir = _copy(killed_dir, out_dir)

    def short(payload):
        payload['optimiser']['count'] -= 1

    _edit_payload(exp_dir, short)
    run.start_run(name, dataset, out_dir, device, overrides, resume=True, n=1).wait(timeout)
    return exp_dir


def batch_norm_reset(exp_dir, out_dir):
    """``model-latest`` with every batch norm's running statistics back at
    their initial values (mean 0, variance 1, no batches tracked)."""
    exp_dir = _copy(exp_dir, out_dir)
    initial = {'running_mean': torch.zeros_like, 'running_var': torch.ones_like,
               'num_batches_tracked': torch.zeros_like}

    def reset(payload):
        for key, value in payload['model'].items():
            kind = key.rpartition('.')[2]
            if kind in initial:
                payload['model'][key] = initial[kind](value)

    _edit_payload(exp_dir, reset)
    return exp_dir


def missing_epoch(exp_dir, out_dir, epoch):
    """``metrics.jsonl`` without epoch ``epoch``'s records (1-based)."""
    exp_dir = _copy(exp_dir, out_dir)
    records = path.join(exp_dir, 'metrics.jsonl')
    with open(records) as f:
        lines = [line for line in f if json.loads(line)['epoch'] != epoch - 1]
    with open(records, 'w') as f:
        f.writelines(lines)
    return exp_dir
