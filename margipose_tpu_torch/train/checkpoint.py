"""Train-state checkpoints: save, crash-safe swap, restore.

Counterpart of ``margipose_tpu/train/checkpoint.py:62-220``. A checkpoint is a directory::

    <ckpt_dir>/state/train_state.pt   model state_dict, optimiser state, step
    <ckpt_dir>/state/meta.json        model_desc, epoch, train datasets
    <ckpt_dir>/meta.json              a copy of the above, for readers

The full state is saved (the reference saved but never restored optimiser
state and epoch; reference: src/margipose/bin/train_3d.py:285-291,374-382).
A save writes ``state.next`` and swaps it in with renames, keeping the
previous ``state`` as ``state.old`` until the new one is on disk, so a
process killed mid-save never loses the last good checkpoint: restore falls
back to ``state.old``.

Here the port deliberately departs from the JAX package's order
(``margipose_tpu/train/checkpoint.py:85-97``), which has two windows in
which a kill leaves a wrong or no checkpoint:

  * the meta travels inside the state directory, written before the swap,
    so a payload and its meta are one unit. JAX replaces the top-level
    ``meta.json`` after the swap, and a kill between the two pairs epoch
    k+1's state with epoch k's meta: the resume trains an epoch too many.
    ``load_meta``, ``load_payload`` and so ``restore_checkpoint`` and
    ``checkpoint.load_model`` all read the directory ``_state_dir`` picks;
  * ``state.old`` is removed only while a complete ``state`` exists. JAX
    removes it first, so a save after a resume from ``state.old`` (``state``
    missing) had a window with neither on disk.

Under a process group of several processes all of them call
``save_checkpoint``, process 0 alone writes and swaps, fenced by barriers
so that no process restores or saves again before the swap is done, and the
save is synchronous (the JAX package's multi-host saves are collective and
synchronous too). A model sharded over a mesh's 'model' axis
(``parallel/mesh.shard_variables``) is gathered first, its weights and its
optimiser's buffers, so the file holds the plain model's layout, as orbax
writes the JAX package's global arrays: it loads with
``load_state_dict(strict=True)`` into the plain model, and
``restore_checkpoint`` cuts it back into a sharded one.
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
META_FILE = 'meta.json'


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


def _write_json(file: str, obj: dict) -> None:
    """``obj`` to ``file`` through a temporary name and a rename."""
    with open(file + '.tmp', 'w') as f:
        json.dump(obj, f, indent=2, sort_keys=True)
    os.replace(file + '.tmp', file)


def _write_and_swap(ckpt_dir: str, payload: dict, meta: dict):
    nxt = path.join(ckpt_dir, 'state.next')
    old = path.join(ckpt_dir, 'state.old')
    final = path.join(ckpt_dir, 'state')
    for stale in glob.glob(path.join(ckpt_dir, 'state.next*')):  # an interrupted save's
        shutil.rmtree(stale, ignore_errors=True)
    os.makedirs(nxt)
    torch.save(payload, path.join(nxt, STATE_FILE))
    _write_json(path.join(nxt, META_FILE), meta)
    if path.isdir(final):  # else keep state.old, the only complete state, until the swap
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
    os.rename(nxt, final)
    _write_json(path.join(ckpt_dir, META_FILE), meta)
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
    model_state = mesh.full_state_dict(state.model)
    optimiser_state = {'count': state.optimiser.count, 'optimiser': mesh.full_optimiser_state(
        state.optimiser.optimiser, state.model)}  # ScheduledOptimiser.state_dict's layout
    if mesh.process_index() == 0:
        payload = _to_host({'step': state.step, 'model': model_state,
                            'optimiser': optimiser_state})
        meta = {'model_desc': model_desc, **(extra or {})}
        if background and not multi:
            thread = _BackgroundSave(_write_and_swap, (ckpt_dir, payload, meta))
        else:
            _write_and_swap(ckpt_dir, payload, meta)
    if multi:
        mesh.barrier()
    return thread


def save_weights(ckpt_dir: str, model: torch.nn.Module, model_desc: dict) -> None:
    """A weights-only checkpoint in ``save_checkpoint``'s layout: the model's
    state_dict and no optimiser state or step (the counterpart of the JAX
    package's weights-only ``save_model``). ``checkpoint.load_model`` reads
    it; ``restore_checkpoint`` needs a full train state. A sharded model is
    gathered (every process calls this) and process 0 writes."""
    model_state = mesh.full_state_dict(model)
    if mesh.process_index() == 0:
        _write_and_swap(path.abspath(ckpt_dir), _to_host({'model': model_state}),
                        {'model_desc': model_desc})


def _state_dir(ckpt_dir: str) -> str:
    """``state``, or ``state.old`` where a save was interrupted before its
    swap: the one complete state on disk."""
    state_dir = path.join(ckpt_dir, 'state')
    if not path.isdir(state_dir):
        old = path.join(ckpt_dir, 'state.old')
        if path.isdir(old):
            print(f"checkpoint: '{state_dir}' missing (interrupted save?); "
                  f"falling back to '{old}'")
            state_dir = old
    return state_dir


def _state_file(ckpt_dir: str) -> str:
    return path.join(_state_dir(ckpt_dir), STATE_FILE)


def load_payload(ckpt_dir: str) -> dict:
    """The saved ``{step, model, optimiser}`` on the CPU."""
    return torch.load(_state_file(path.abspath(ckpt_dir)), map_location='cpu',
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, state) -> None:
    """Load a train state saved by ``save_checkpoint`` into ``state`` in place:
    the model's weights and buffers (strict), the optimiser and the step. A
    sharded model and its optimiser take their slices."""
    payload = load_payload(ckpt_dir)
    mesh.load_full_state_dict(state.model, payload['model'])
    saved = payload['optimiser']
    state.optimiser.load_state_dict({**saved, 'optimiser': mesh.local_optimiser_state(
        saved['optimiser'], state.optimiser.optimiser, state.model)})
    state.step = int(payload['step'])


def load_meta(ckpt_dir: str) -> dict:
    """The meta saved with the state ``load_payload`` reads."""
    with open(path.join(_state_dir(path.abspath(ckpt_dir)), META_FILE)) as f:
        return json.load(f)
