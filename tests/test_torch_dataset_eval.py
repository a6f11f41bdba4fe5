"""The port's eval bin on MPI-INF-3DHP and Human3.6M against the JAX eval bin.

A small checkpoint (inceptionv4, 2 stages, 64 px) of a calibrated JAX
MargiPose (``test_torch_weights.jax_margipose`` on the port's seeded
initialisation, no JAX init to compile), exported to the reference ``.pth``
format, is evaluated by both bins on the CPU, on a fake ``mpi3d-test`` (two
sequences of two frames, two activities) and a fake ``h36m-test``, at batch
2. Overall tables agree to 0.1 mm MPJPE and 1e-3 PCK and AUC, as the
synthetic eval does (tests/test_torch_eval_bin.py), with the same sequence
and activity keys. The port's bin evaluates ``mpi3d-test`` when no
``--dataset`` is given, as JAX's does. ``--multicrop`` is held in
tests/test_torch_dataset_multicrop.py.
"""

import os

import numpy as np
import pytest
import torch

import margipose_tpu_torch.bin.eval_3d as eval_3d
from margipose_tpu.data.fake_mpi3d import generate_fake_mpi3d
from margipose_tpu.data.fakes import generate_fake_h36m
from margipose_tpu.train.torch_import import export_state_dict
from test_torch_eval_bin import METRICS, _assert_tables_agree, _run_jax_eval
from test_torch_weights import jax_margipose, port_init_as_jax, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    desc = small_desc()
    _, variables = jax_margipose(desc, seed=4, variables=port_init_as_jax(desc, seed=4))
    path = str(tmp_path_factory.mktemp('ckpt') / 'small.pth')
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in export_state_dict(variables).items()}
    torch.save({'state_dict': state, 'model_desc': desc}, path)
    return path


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('datasets'))
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'test'), seqs=((1, 1), (2, 1)),
                        camera_ids=(0,), n_frames=2, with_activities=True)
    generate_fake_h36m(os.path.join(base, 'h36m'), subjects=(9,), camera_ids=(1,), n_frames=2)
    return base


@pytest.fixture(autouse=True)
def _environment(corpus, monkeypatch):
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', corpus)


def assert_bins_agree(rows, df):
    assert len(rows['mpjpe']) == len(df)
    _assert_tables_agree(eval_3d.overall_metrics(rows), df[list(METRICS)].mean())
    assert sorted(set(rows['seq_id'])) == sorted(set(df['seq_id']))
    assert sorted(map(str, set(rows['activity_id']))) == sorted(map(str, set(df['activity_id'])))


def test_mpi3d_test_eval_matches_jax(checkpoint, monkeypatch, capsys):
    df, _ = _run_jax_eval(['--model', checkpoint, '--dataset', 'mpi3d-test',
                           '--batch-size', '2'], monkeypatch)
    capsys.readouterr()
    # no --dataset: the port's default is JAX's, mpi3d-test
    rows, stats = eval_3d.main(['--model', checkpoint, '--batch-size', '2', '--device', 'cpu'])
    printed = capsys.readouterr().out
    for heading in ('### By sequence', '### By activity', '### Overall'):
        assert heading in printed
    assert 'Use ground truth root joint depth? False' in printed
    assert 'Number of joints in evaluation: 14' in printed
    assert 'TS1/Seq1' in printed and 'TS2/Seq1' in printed
    assert stats['batches'] == 2
    assert_bins_agree(rows, df)


def test_h36m_test_eval_matches_jax(checkpoint, monkeypatch, capsys):
    args = ['--model', checkpoint, '--dataset', 'h36m-test', '--batch-size', '2']
    df, _ = _run_jax_eval(args, monkeypatch)
    capsys.readouterr()
    rows, stats = eval_3d.main(args + ['--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'Use ground truth root joint depth? True' in printed
    assert 'Number of joints in evaluation: 17' in printed
    assert stats['batches'] == 1
    assert_bins_agree(rows, df)


def test_eval_defaults_to_mpi3d_test():
    assert eval_3d.parse_args(['--model', 'x.pth']).dataset == 'mpi3d-test'
