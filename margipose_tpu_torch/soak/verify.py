"""Verify a soak's experiment directory.

Port of ``scripts/soak_verify.py``, with its checks and limits:

1. the recorded metrics traverse the reference 1cycle trajectory (reference:
   src/margipose/hyperparam_scheduler.py:6-21): every epoch's (lr, momentum)
   equals ``train.schedules.schedule_values`` at the epoch's last update
   within 1e-6; the peak near lr_max at 0.45T, lr_max/10 at 0.9T,
   lr_max/1e4 at T, momentum 0.9 -> 0.85 -> 0.9;
2. the run converged through the anneal (the median loss of the last tenth
   of the epochs below that of the tenth after warmup) with no blow-up at
   the end;
3. the final checkpoint restores at epoch T.

The port reads more than the JAX script could, and differs where a kill or
the absence of the reference's code asks it to:

* **What the optimiser applied.** The bin records lr and momentum from the
  formula it applies, so the records alone cannot show a schedule the
  optimiser did not follow. The final checkpoint's optimiser state is read
  as well: its update ``count`` and the train step must be T updates, and
  the lr and momentum of its torch SGD ``param_groups`` (what the last
  update applied) must equal ``schedule_values`` at update T-1.
* **Records across a kill.** A kill can land after an epoch's record but
  before that epoch's background save ends; the resumed run then records
  the epoch again. The last record of each epoch is kept, and every epoch
  must be there.
* **The reference check.** In place of a forward of the reference's own
  executed model (not present here; the test suite holds the port's
  checkpoint against the JAX package's forward instead),
  ``checkpoint.load_model`` must strict-load ``model-latest`` in this
  process (not the one that trained), and ``bin.eval_3d`` on it must give,
  within 1e-6, the per-example metrics and mean loss that the training
  process's eval of its live state recorded (``soak_run.json``).
* **Short runs.** The decade checks (1's shape, 2) compare tenths of the run,
  so they run from 10 epochs on. The 0.9T and momentum-dip checks keep the
  JAX script's samples and limits; where the epoch boundaries fall so far
  from 0.9T or from the dip that the schedule itself, read at those
  boundaries, misses the JAX limit (at 12 epochs, say), no run could pass
  them, and each prints a SKIP line with that reading in place of its check.
  The 1e-6 trajectory check still holds every recorded epoch.

``python -m margipose_tpu_torch.soak verify EXP_DIR`` exits non-zero on any
FAIL.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
from os import path

import numpy as np

EVAL_ATOL = 1e-6
SCHEDULE_ATOL = 1e-6


class Checks:
    """The lines of a verification, printed as they come."""

    def __init__(self, out=print):
        self.out, self.ok, self.lines = out, True, []

    def __call__(self, name, cond, detail=''):
        self.say(f"[{'PASS' if cond else 'FAIL'}] {name}" + (f' — {detail}' if detail else ''))
        self.ok = self.ok and bool(cond)

    def say(self, line):
        self.lines.append(line)
        self.out(line)


def read_records(exp_dir, check):
    """(config, the last record of each epoch in epoch order, epochs
    recorded more than once)."""
    with open(path.join(exp_dir, 'config.json')) as f:
        cfg = json.load(f)
    with open(path.join(exp_dir, 'metrics.jsonl')) as f:
        raw = [json.loads(line) for line in f if line.strip()]
    last = {int(record['epoch']): record for record in raw}
    counts = collections.Counter(int(record['epoch']) for record in raw)
    repeated = sorted(e for e, n in counts.items() if n > 1)
    epochs = int(cfg['epochs'])
    check.say(f'metrics.jsonl: {len(raw)} records; epochs recorded again after a kill: '
              f'{[e + 1 for e in repeated] or "none"} (the last record of each kept)')
    missing = [e + 1 for e in range(epochs) if e not in last]
    check('all epochs recorded', not missing and len(last) == epochs,
          f'{len(last)}/{epochs}' + (f', missing epochs {missing}' if missing else ''))
    return cfg, [last[e] for e in sorted(last)], repeated


def check_schedule(cfg, records, check):
    from margipose_tpu_torch.train.schedules import schedule_values

    epochs, lr_max = int(cfg['epochs']), float(cfg['lr'])
    # floor division: the training loader drops the last partial batch
    steps_per_epoch = int(cfg['train_examples']) // int(cfg['batch_size'])
    max_iters = epochs * steps_per_epoch
    numbers = [int(r['epoch']) + 1 for r in records]
    lrs = np.array([r['lr'] for r in records])
    moms = np.array([r['momentum'] for r in records])
    expected = np.array([schedule_values(cfg['optim_algorithm'], lr_max, e * steps_per_epoch - 1,
                                         max_iters=max_iters) for e in numbers])
    lr_err = np.abs(lrs - expected[:, 0]).max()
    mom_err = np.abs(moms - expected[:, 1]).max()
    check('recorded lr trajectory == reference schedule at epoch boundaries',
          lr_err < SCHEDULE_ATOL, f'max |lr delta| {lr_err:.2e}')
    check('recorded momentum trajectory == reference schedule', mom_err < SCHEDULE_ATOL,
          f'max |momentum delta| {mom_err:.2e}')
    if epochs < 10 or len(records) != epochs:
        check.say(f'[SKIP] 1cycle shape and convergence checks: they compare tenths of the '
                  f'run, so they need all of 10 or more epochs ({len(records)} of {epochs})')
        return
    # epoch-boundary samples straddle the exact 0.45T peak, so the max
    # recorded lr sits within one epoch's slope of lr_max
    peak_tol = 0.9 * lr_max / (0.45 * epochs)
    check('peak lr reaches lr_max mid-cycle (within one epoch\'s slope)',
          abs(lrs.max() - lr_max) < peak_tol and 0.3 < lrs.argmax() / epochs < 0.6,
          f'max lr {lrs.max():.4g} at epoch {lrs.argmax()}')
    check('terminal anneal endpoint lr_max/1e4', abs(lrs[-1] - lr_max * 1e-4) < lr_max * 2e-5,
          f'final lr {lrs[-1]:.3g}')
    i_09T = int(0.9 * epochs) - 1
    if abs(expected[i_09T, 0] - lr_max * 0.1) < lr_max * 0.02:
        check('lr back at lr_max/10 at 0.9T', abs(lrs[i_09T] - lr_max * 0.1) < lr_max * 0.02,
              f'lr(0.9T) {lrs[i_09T]:.4g}')
    else:
        check.say(f'[SKIP] lr back at lr_max/10 at 0.9T: the schedule itself reads '
                  f'{expected[i_09T, 0]:.4g} at epoch {i_09T + 1}\'s end, outside the limit '
                  f'{lr_max * 0.02:.4g} of {lr_max * 0.1:.4g}')
    if abs(expected[:, 1].min() - 0.85) < 1e-3:
        check('momentum dips to 0.85 mid-cycle and returns to 0.9',
              abs(moms.min() - 0.85) < 1e-3 and abs(moms[-1] - 0.9) < 1e-3
              and abs(moms[0] - 0.9) < 0.05,
              f'min {moms.min():.3f}, final {moms[-1]:.3f}')
    else:
        check.say(f'[SKIP] momentum dips to 0.85 mid-cycle and returns to 0.9: the schedule '
                  f'itself reads at least {expected[:, 1].min():.4f} at the epochs\' ends, '
                  f'outside the limit 1e-3 of 0.85')
    losses = np.array([r['train_loss'] for r in records])
    d = epochs // 10
    first = np.median(losses[d:2 * d])  # the tenth after warmup
    last = np.median(losses[-d:])       # the anneal's tenth
    check('monotone-ish convergence (last decade < post-warmup decade)', last < first,
          f'median loss {first:.4f} -> {last:.4f}')
    check('no terminal blow-up', np.isfinite(losses).all() and losses[-1] < 1.5 * last,
          f'final loss {losses[-1]:.4f}')


def check_checkpoint(exp_dir, cfg, check):
    from margipose_tpu_torch.train import checkpoint as ckpt
    from margipose_tpu_torch.train.schedules import schedule_values

    latest = path.join(exp_dir, 'model-latest')
    epochs = int(cfg['epochs'])
    max_iters = epochs * (int(cfg['train_examples']) // int(cfg['batch_size']))
    meta = ckpt.load_meta(latest)
    check('final checkpoint restores at epoch T', int(meta.get('epoch', -1)) == epochs,
          f"epoch {meta.get('epoch')}")
    payload = ckpt.load_payload(latest)
    count = int(payload['optimiser']['count'])
    check('optimiser update count and train step == T updates',
          count == max_iters and int(payload['step']) == max_iters,
          f"count {count}, step {payload['step']}, T {max_iters}")
    want = schedule_values(cfg['optim_algorithm'], float(cfg['lr']), max_iters - 1,
                           max_iters=max_iters)
    groups = payload['optimiser']['optimiser']['param_groups']
    err = max(max(abs(g['lr'] - want[0]), abs(g['momentum'] - want[1])) for g in groups)
    check('the optimiser\'s last applied (lr, momentum) == schedule at update T-1',
          err < SCHEDULE_ATOL, f"({groups[0]['lr']:.6g}, {groups[0]['momentum']:.6g}) vs "
                               f'({want[0]:.6g}, {want[1]:.6g}), max delta {err:.2e}')


def check_restore(exp_dir, check, device=None):
    """Strict load and the fresh eval against the training process's."""
    from margipose_tpu_torch.bin import eval_3d
    from margipose_tpu_torch.checkpoint import load_model

    latest = path.join(exp_dir, 'model-latest')
    record_file = path.join(exp_dir, 'soak_run.json')
    if not path.exists(record_file):
        check('the training process recorded an eval of its live state', False,
              f'{record_file} missing')
        return
    with open(record_file) as f:
        record = json.load(f)
    argv = list(record['eval']['argv'])
    argv[argv.index('--model') + 1] = latest
    if device is not None:
        argv[argv.index('--device') + 1] = device
    try:
        load_model(latest, 'cpu')  # only that it loads strictly
    except (RuntimeError, KeyError) as exc:
        check('model-latest strict-loads in a fresh process', False, str(exc)[:200])
        return
    check('model-latest strict-loads in a fresh process', True)
    with contextlib.redirect_stdout(io.StringIO()):
        rows, stats = eval_3d.main(argv)
    want = record['eval']
    errs = {m: float(np.max(np.abs(np.subtract(rows[m], want['rows'][m]))))
            for m in eval_3d.METRICS}
    loss_err = abs(stats['mean_loss'] - want['mean_loss'])
    worst = max(errs, key=errs.get)
    check('bin.eval_3d in a fresh process == the training process\'s eval of its live state',
          max(errs.values()) <= EVAL_ATOL and loss_err <= EVAL_ATOL
          and len(rows['mpjpe']) == len(want['rows']['mpjpe']),
          f"{' '.join(argv[argv.index('--dataset'):argv.index('--dataset') + 2])}, "
          f"{len(rows['mpjpe'])} examples: worst {worst} delta {errs[worst]:.3g}, mean loss "
          f"{stats['mean_loss']:.8g} vs {want['mean_loss']:.8g} (atol {EVAL_ATOL:g}); mpjpe "
          f"{np.mean(rows['mpjpe']):.2f} mm, pck {np.mean(rows['pck']):.4f}")


def check_launches(exp_dir, check):
    """On the card, both kernels launched by the host once an eager or a
    capturing step of the run that ended (a step replayed from the train
    step's CUDA graph runs them without a host launch), and the three kinds
    of step adding up to the run's steps."""
    with open(path.join(exp_dir, 'soak_run.json')) as f:
        record = json.load(f)
    steps = record['step'] - record['start_step']
    if not record['device'].startswith('cuda'):
        check.say(f"[SKIP] kernel launches: the run was on {record['device']}, where the "
                  f'wrappers run the plain versions ({steps} steps)')
        return
    counts = record['step_counts']
    host = counts['eager_steps'] + counts['captures']
    want = {'dsnt_jsd_fwd': host, 'dsnt_jsd_bwd': host}
    check('both kernels launched by the host once an eager or capturing step of the run that '
          'ended', record['launches'] == want and sum(counts.values()) == steps > 0,
          f"{record['launches']} in {steps} steps ({counts}) on {record['device_name']}")


def trajectory(records, key):
    """The median of ``key`` over each tenth of the epochs (fewer, shorter
    runs: each epoch)."""
    values = np.array([r[key] for r in records if r.get(key) is not None], dtype=float)
    parts = np.array_split(values, min(10, len(values))) if len(values) else []
    return [float(np.median(p)) for p in parts]


def verify(exp_dir, device=None, out=print) -> Checks:
    """Every check on ``exp_dir``; the eval runs on ``device`` (default:
    the training run's). Returns the ``Checks`` (``.ok``, ``.lines``)."""
    check = Checks(out)
    cfg, records, _ = read_records(exp_dir, check)
    check_schedule(cfg, records, check)
    for key in ('train_loss', 'train_mpjpe'):
        check.say(f'{key} by tenths of the epochs (median): '
                  + ', '.join(f'{v:.4f}' for v in trajectory(records, key)))
    check_checkpoint(exp_dir, cfg, check)
    check_restore(exp_dir, check, device)
    if path.exists(path.join(exp_dir, 'soak_run.json')):
        check_launches(exp_dir, check)
    check.say('soak verification: ' + ('ALL PASS' if check.ok else 'FAILURES'))
    return check


def main(exp_dir, device=None) -> int:
    return 0 if verify(os.path.abspath(exp_dir), device).ok else 1
