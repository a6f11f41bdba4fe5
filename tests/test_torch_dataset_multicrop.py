"""The port's ``eval_3d --multicrop`` on MPI-INF-3DHP against the JAX bin's.

The checkpoint of tests/test_torch_dataset_eval.py, on a fake
``mpi3d-test`` of two sequences of one frame: each example's 10 crops (2
flips x 5 offsets) give one crop-averaged prediction. Overall tables agree
to 0.1 mm MPJPE and 1e-3 PCK and AUC, with the same sequence and activity
keys.
"""

import os

import pytest
import torch

import margipose_tpu_torch.bin.eval_3d as eval_3d
from margipose_tpu.data.fake_mpi3d import generate_fake_mpi3d
from test_torch_dataset_eval import assert_bins_agree, checkpoint  # noqa: F401
from test_torch_eval_bin import _run_jax_eval

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    generate_fake_mpi3d(str(tmp_path / 'mpi3d' / 'test'), seqs=((1, 1), (2, 1)),
                        camera_ids=(0,), n_frames=1, with_activities=True)
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', str(tmp_path))


def test_mpi3d_test_multicrop_matches_jax(checkpoint, corpus, monkeypatch, capsys):  # noqa: F811
    df, _ = _run_jax_eval(['--model', checkpoint, '--dataset', 'mpi3d-test', '--multicrop'],
                          monkeypatch)
    capsys.readouterr()
    rows, stats = eval_3d.main(['--model', checkpoint, '--multicrop', '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'time per example (all crops)' in printed and 'TS2/Seq1' in printed
    assert stats['batches'] == len(rows['mpjpe']) == 2
    assert_bins_agree(rows, df)
