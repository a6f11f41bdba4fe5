"""The port's train bin resumed from its epoch-1 checkpoint ends where an
uninterrupted run does, bit for bit, on the CPU (the run of
``test_torch_train_bin.py``, in a file of its own so that its three runs
share no worker's wall time with that file's)."""

import os

import pytest
import torch

import margipose_tpu_torch.bin.train_3d as train_3d
from margipose_tpu_torch.train import checkpoint as ckpt
from test_torch_train_bin import _argv, _assert_states_equal, _final_state, train_first_run

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def first_run(tmp_path_factory):
    return train_first_run(tmp_path_factory)


def test_resume_equals_an_uninterrupted_run(first_run, tmp_path, monkeypatch):
    out, _ = first_run
    real_pass = train_3d.do_training_pass
    calls = []

    def stop_in_second_epoch(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real_pass(*args, **kwargs)

    monkeypatch.setattr(train_3d, 'do_training_pass', stop_in_second_epoch)
    with pytest.raises(KeyboardInterrupt):
        train_3d.main(_argv(str(tmp_path)))
    monkeypatch.setattr(train_3d, 'do_training_pass', real_pass)
    latest = os.path.join(str(tmp_path), 'run', 'model-latest')
    assert ckpt.load_meta(latest)['epoch'] == 1
    result = train_3d.main(_argv(str(tmp_path), f'resume={latest}', experiment_id='resumed'))
    assert result['step'] == 4
    _assert_states_equal(_final_state(out), _final_state(str(tmp_path), 'resumed'))
