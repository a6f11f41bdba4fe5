"""The soak's runner: training processes started, killed and resumed.

A soak trains through ``soak/child.py`` in a child process of its own
session, so that a kill is a real crash of the process and of every thread
in it: ``os.killpg(..., SIGKILL)``, no exception, no ``finally``. With
``kill_at=k`` the runner SIGKILLs the first process once
``model-latest/meta.json`` says epoch k or later (a background save may
have finished more); with ``kill_in_save=j`` a resumed process is SIGKILLed
halfway through epoch j's save (``child.py --pause-in-save``). Each kill is
followed by a run with ``resume=`` into the same experiment directory, and
the last process runs to the end and writes ``soak_run.json`` there.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from os import path

from margipose_tpu_torch.soak.recipes import EVAL_BATCH_SIZE, RECIPES

RECORD = 'soak_run.json'
POLL_SECONDS = 0.02


def saved_epoch(exp_dir):
    """The epoch ``<exp_dir>/model-latest/meta.json`` says is saved (0
    while there is none)."""
    try:
        with open(path.join(exp_dir, 'model-latest', 'meta.json')) as f:
            return int(json.load(f).get('epoch', 0))
    except (OSError, ValueError):
        return 0  # not written yet, or being replaced


class Child:
    """One training process (``soak/child.py``), its output in ``log``."""

    def __init__(self, words, device, record, eval_dataset, eval_batch_size, log,
                 pause_in_save=None):
        argv = [sys.executable, '-m', 'margipose_tpu_torch.soak.child', '--record', record,
                '--eval-dataset', eval_dataset, '--eval-batch-size', str(eval_batch_size),
                '--device', device]
        if pause_in_save is not None:
            argv += ['--pause-in-save', str(pause_in_save)]
        self.log = log
        self.marker = record + '.paused'
        with open(log, 'w') as out:
            self.proc = subprocess.Popen(argv + ['--', *words], stdout=out,
                                         stderr=subprocess.STDOUT, start_new_session=True)

    def tail(self, n=3000):
        with open(self.log) as f:
            return f.read()[-n:]

    def kill(self):
        """SIGKILL the process and everything in its session."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def wait(self, timeout):
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise RuntimeError(f'soak process exceeded {timeout} s:\n{self.tail()}') from None
        if rc:
            raise RuntimeError(f'soak process exited {rc}:\n{self.tail()}')

    def wait_for(self, ready, timeout):
        """Poll ``ready()`` until it is true; raises if the process ended
        first or ``timeout`` passed."""
        deadline = time.monotonic() + timeout
        while not ready():
            if self.proc.poll() is not None:
                raise RuntimeError(f'soak process ended (rc {self.proc.returncode}) before '
                                   f'the kill:\n{self.tail()}')
            if time.monotonic() > deadline:
                self.kill()
                raise RuntimeError(f'soak process not ready in {timeout} s:\n{self.tail()}')
            time.sleep(POLL_SECONDS)


def start_run(name, dataset, out_dir, device='cuda', overrides=(), resume=False,
              pause_in_save=None, n=1):
    """Start training process ``n`` of soak ``name`` on ``dataset`` into
    ``out_dir`` (``resume``: from its model-latest); returns its ``Child``."""
    recipe = RECIPES[name]
    exp_dir = path.join(out_dir, recipe.experiment_id)
    words = recipe.train_words(dataset, out_dir, overrides)
    if resume:
        words.append(f"resume={path.join(exp_dir, 'model-latest')}")
    return Child(words, device, path.join(exp_dir, RECORD), recipe.eval_dataset[dataset],
                 EVAL_BATCH_SIZE, path.join(out_dir, f'{recipe.experiment_id}.run{n}.log'),
                 pause_in_save)


def run_recipe(name, dataset, out_dir, device='cuda', kill_at=None, kill_in_save=None,
               overrides=(), timeout=3600, keep_killed=False, log=print):
    """Run soak ``name`` on ``dataset`` into ``out_dir`` and return its
    experiment directory (emptied first). ``kill_at`` / ``kill_in_save``:
    the crashes above, in that order; ``keep_killed`` copies the directory as
    the first kill left it to ``<exp_dir>.killed``; ``log`` gets one line a
    process."""
    exp_dir = path.join(out_dir, RECIPES[name].experiment_id)
    latest = path.join(exp_dir, 'model-latest')
    shutil.rmtree(exp_dir, ignore_errors=True)
    shutil.rmtree(exp_dir + '.killed', ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    runs = 0

    def start(resume, pause_in_save=None):
        nonlocal runs
        runs += 1
        return start_run(name, dataset, out_dir, device, overrides, resume, pause_in_save,
                         runs)

    resume = False
    if kill_at is not None:
        child = start(resume)
        t0 = time.perf_counter()
        child.wait_for(lambda: saved_epoch(exp_dir) >= kill_at, timeout)
        child.kill()
        log(f'run {runs}: SIGKILLed once model-latest said epoch {kill_at}: it says '
            f'{saved_epoch(exp_dir)} ({time.perf_counter() - t0:.1f} s)')
        if keep_killed:
            shutil.copytree(exp_dir, exp_dir + '.killed')
        resume = True
    if kill_in_save is not None:
        child = start(resume, pause_in_save=kill_in_save)
        t0 = time.perf_counter()
        child.wait_for(lambda: path.exists(child.marker), timeout)
        child.kill()
        os.remove(child.marker)
        held = sorted(os.listdir(latest))
        log(f'run {runs}: SIGKILLed in the save of epoch {kill_in_save}, between its '
            f'renames ({time.perf_counter() - t0:.1f} s): model-latest holds {held}')
        if held != ['meta.json', 'state.next', 'state.old']:
            raise RuntimeError(f'the kill in the save left {held}, not a half swap')
        resume = True
    child = start(resume)
    t0 = time.perf_counter()
    child.wait(timeout)
    log(f'run {runs}: {"resumed and " if resume else ""}ran to the end '
        f'({time.perf_counter() - t0:.1f} s)')
    return exp_dir
