"""The port's train bin repeats a seeded run bit for bit on the CPU, and
another seed trains other weights (the run of ``test_torch_train_bin.py``,
in a file of its own so that its three runs share no worker's wall time
with that file's)."""

import pytest
import torch

import margipose_tpu_torch.bin.train_3d as train_3d
from test_torch_train_bin import _argv, _assert_states_equal, _final_state, train_first_run

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def first_run(tmp_path_factory):
    return train_first_run(tmp_path_factory)


def test_same_seed_repeats_and_another_seed_differs(first_run, tmp_path):
    out, result = first_run
    again = train_3d.main(_argv(str(tmp_path)))
    _assert_states_equal(_final_state(out), _final_state(str(tmp_path)))
    assert again['train_loss'] == result['train_loss']

    train_3d.main(_argv(str(tmp_path), seed=4, experiment_id='other'))
    other = _final_state(str(tmp_path), 'other')['model']
    assert not torch.equal(other['inner.in_cnn.0.conv.weight'],
                           _final_state(out)['model']['inner.in_cnn.0.conv.weight'])
