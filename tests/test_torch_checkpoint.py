"""The port's checkpoints under a kill at every step of a save, and
``checkpoint.load_model``'s device.

``train/checkpoint._write_and_swap`` is stopped after each of its file
operations in turn (the payload's write, the meta's write inside
``state.next``, each removal, each rename, the top-level meta's copy) by a
``BaseException`` raised from the operation just done, as a SIGKILL would
leave the directory. It starts from a directory holding a complete ``state``
of epoch 1, or only the ``state.old`` of epoch 1 that an earlier kill left.
After every stop the restore must find a state, and the payload and the meta
it reads must be of one epoch. The JAX package's order, which the port kept
until now, fails both: a stop between the swap and the meta's write pairs
epoch 2's state with epoch 1's meta, and from ``state.old`` alone a stop
after its removal leaves nothing.
"""

import os
import shutil

import pytest
import torch

from margipose_tpu_torch.checkpoint import load_model, save_model
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.train import checkpoint as ckpt
from test_torch_train_bin import _tiny_state

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

OPERATIONS = ((torch, 'save'), (os, 'replace'), (os, 'rename'), (shutil, 'rmtree'))
MAX_STEPS = 7  # file operations in a save over a complete state; fewer from state.old


class Killed(BaseException):
    pass


def _state(epoch):
    """A tiny train state whose step is ``epoch``."""
    state = _tiny_state(epoch)
    state.step = epoch
    return state


def _save(ckpt_dir, state):
    ckpt.save_checkpoint(ckpt_dir, state, {'type': 'test'}, extra={'epoch': state.step})


def _kill_after(monkeypatch, n, done):
    """Each of OPERATIONS runs, is recorded in ``done``, and the ``n``-th
    raises ``Killed`` once it has run."""
    for module, name in OPERATIONS:
        real = getattr(module, name)

        def operation(*args, _real=real, _name=name, **kwargs):
            out = _real(*args, **kwargs)
            done.append(f'{_name} {os.path.basename(str(args[-1]))}')
            if len(done) == n:
                raise Killed(done[-1])
            return out

        monkeypatch.setattr(module, name, operation)


@pytest.mark.parametrize('start', ['state', 'state.old only'])
@pytest.mark.parametrize('stop', range(1, MAX_STEPS + 1))
def test_a_save_killed_at_any_step_restores_one_epoch(tmp_path, monkeypatch, start, stop):
    ckpt_dir = str(tmp_path / 'model-latest')
    states = {epoch: _state(epoch) for epoch in (1, 2, 3)}
    _save(ckpt_dir, states[1])
    if start == 'state.old only':
        os.rename(os.path.join(ckpt_dir, 'state'), os.path.join(ckpt_dir, 'state.old'))
    done = []
    with monkeypatch.context() as patch:
        _kill_after(patch, stop, done)
        try:
            _save(ckpt_dir, states[2])
            killed = False
        except Killed:
            killed = True
    assert killed or len(done) < stop, done

    meta, payload = ckpt.load_meta(ckpt_dir), ckpt.load_payload(ckpt_dir)
    assert meta['epoch'] == payload['step'], (done, sorted(os.listdir(ckpt_dir)))
    assert meta['epoch'] == 2 or (killed and meta['epoch'] == 1)
    restored = _tiny_state(4)
    ckpt.restore_checkpoint(ckpt_dir, restored)
    assert restored.step == meta['epoch']
    for key, value in states[meta['epoch']].model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[key], value), key

    # the next save, uninterrupted, cleans up whatever the kill left
    _save(ckpt_dir, states[3])
    assert sorted(os.listdir(ckpt_dir)) == ['meta.json', 'state']
    assert ckpt.load_meta(ckpt_dir)['epoch'] == ckpt.load_payload(ckpt_dir)['step'] == 3


def test_load_model_defaults_to_the_card(tmp_path):
    """``load_model`` runs on the card unless asked for the CPU, and asking
    for the card where there is none is ``resolve_device``'s error, never a
    silent CPU load."""
    desc = {'type': 'margipose', 'version': '6.0.1',
            'settings': {'n_stages': 1, 'input_size': 64}}
    pth = str(tmp_path / 'model.pth')
    save_model(pth, create_model(desc, generator=torch.Generator().manual_seed(0)), desc)
    model, got_desc = load_model(pth, 'cpu')
    assert got_desc == desc and not model.training
    assert next(model.parameters()).device == torch.device('cpu')
    if torch.cuda.is_available():
        assert next(load_model(pth)[0].parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match=r'torch.cuda.is_available\(\) is False'):
            load_model(pth)
