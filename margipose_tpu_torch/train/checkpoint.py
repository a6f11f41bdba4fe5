"""Train-state checkpoints: save, crash-safe swap, restore.

Counterpart of ``margipose_tpu/train/checkpoint.py:62-220``. A checkpoint is a directory::

    <ckpt_dir>/state/train_state.pt   model state_dict, optimiser state, step
    <ckpt_dir>/meta.json              model_desc, epoch, train datasets

The full state is saved (the reference saved but never restored optimiser
state and epoch; reference: src/margipose/bin/train_3d.py:285-291,374-382).
A save writes ``state.next`` and swaps it in with renames, keeping the
previous ``state`` as ``state.old`` until the new one is on disk, so a
process killed mid-save never loses the last good checkpoint: restore falls
back to ``state.old``.

Under a process group of several processes every process holds the same
replicated state: all of them call ``save_checkpoint``, process 0 alone
writes and swaps, fenced by barriers so that no process restores or saves
again before the swap is done, and the save is synchronous (the JAX
package's multi-host saves are collective and synchronous too).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
from os import path

import torch

from margipose_tpu_torch.parallel import mesh

STATE_FILE = 'train_state.pt'


def _to_host(obj):
    """A copy of ``obj`` with every tensor cloned to the CPU: training goes on
    updating the live tensors in place while a background save writes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write_and_swap(ckpt_dir: str, payload: dict, meta: dict):
    nxt = path.join(ckpt_dir, 'state.next')
    old = path.join(ckpt_dir, 'state.old')
    final = path.join(ckpt_dir, 'state')
    for stale in glob.glob(path.join(ckpt_dir, 'state.next*')):  # an interrupted save's
        shutil.rmtree(stale, ignore_errors=True)
    os.makedirs(nxt)
    torch.save(payload, path.join(nxt, STATE_FILE))
    shutil.rmtree(old, ignore_errors=True)
    if path.isdir(final):
        os.rename(final, old)
    os.rename(nxt, final)
    meta_tmp = path.join(ckpt_dir, 'meta.json.tmp')
    with open(meta_tmp, 'w') as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(meta_tmp, path.join(ckpt_dir, 'meta.json'))
    shutil.rmtree(old, ignore_errors=True)


class _BackgroundSave:
    """Daemon save thread whose ``join()`` re-raises any save exception: a
    silently dead background save would let training run on with a stale (or
    no) checkpoint on disk."""

    def __init__(self, target, args):
        self._exc: BaseException | None = None

        def _run():
            try:
                target(*args)
            except BaseException as exc:  # re-raised on join()
                self._exc = exc

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def join(self, timeout: float | None = None):
        self._thread.join(timeout)
        if self._exc is not None and not self._thread.is_alive():
            exc, self._exc = self._exc, None
            raise exc


def save_checkpoint(ckpt_dir: str, state, model_desc: dict, extra: dict | None = None,
                    background: bool = False):
    """Save ``state`` (a ``train.steps.TrainState``) and ``model_desc`` to
    ``ckpt_dir``, overwriting, crash-safely (see the module docstring).

    The copy to host memory is synchronous, since training updates the
    tensors in place. With ``background=True`` the write and the swap run in
    a returned thread: join it before another save to the same directory and
    before relying on the checkpoint; ``join()`` re-raises what the save hit.
    Returns that thread, or None when the save was synchronous. With
    several processes, process 0 writes, between two barriers, and the save
    is synchronous."""
    ckpt_dir = path.abspath(ckpt_dir)
    multi = mesh.process_count() > 1
    if multi:
        mesh.barrier()
    thread = None
    if mesh.process_index() == 0:
        payload = _to_host({'step': state.step, 'model': state.model.state_dict(),
                            'optimiser': state.optimiser.state_dict()})
        meta = {'model_desc': model_desc, **(extra or {})}
        if background and not multi:
            thread = _BackgroundSave(_write_and_swap, (ckpt_dir, payload, meta))
        else:
            _write_and_swap(ckpt_dir, payload, meta)
    if multi:
        mesh.barrier()
    return thread


def _state_file(ckpt_dir: str) -> str:
    state_dir = path.join(ckpt_dir, 'state')
    if not path.isdir(state_dir):
        old = path.join(ckpt_dir, 'state.old')
        if path.isdir(old):
            print(f"checkpoint: '{state_dir}' missing (interrupted save?); "
                  f"falling back to '{old}'")
            state_dir = old
    return path.join(state_dir, STATE_FILE)


def load_payload(ckpt_dir: str) -> dict:
    """The saved ``{step, model, optimiser}`` on the CPU."""
    return torch.load(_state_file(path.abspath(ckpt_dir)), map_location='cpu',
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, state) -> None:
    """Load a train state saved by ``save_checkpoint`` into ``state`` in place:
    the model's weights and buffers (strict), the optimiser and the step."""
    payload = load_payload(ckpt_dir)
    state.model.load_state_dict(payload['model'], strict=True)
    state.optimiser.load_state_dict(payload['optimiser'])
    state.step = int(payload['step'])


def load_meta(ckpt_dir: str) -> dict:
    with open(path.join(ckpt_dir, 'meta.json')) as f:
        return json.load(f)
