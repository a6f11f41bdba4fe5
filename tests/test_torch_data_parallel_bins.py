"""The port's bins across processes and devices, on the CPU.

* The train bin under ``torchrun --nproc_per_node 2`` (gloo): the two
  processes share one experiment directory, named by process 0; only
  process 0 writes ``metrics.jsonl`` (one line an epoch); both end with the
  same weights and buffers, which are the checkpoint's; the eval bin reads
  it.
* ``eval_3d --num-devices N``: N weight replicas (on the CPU all on the one
  device), each batch split into N row blocks and gathered in row order.
  Two replicas give one replica's metrics and loss within 1e-6 (each row's
  forward is the same arithmetic; the loss sums two blocks in place of
  one), and the JAX bin's three argument errors exit the same way.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import margipose_tpu_torch.bin.eval_3d as eval_3d
from margipose_tpu_torch.checkpoint import save_model
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.train import checkpoint as ckpt
from test_torch_weights import small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESC = "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}"


def test_train_bin_under_torchrun_two_processes(tmp_path):
    out = tmp_path / 'runs'
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node',
           '2', os.path.join(ROOT, 'tests', 'torch_dist_workers.py'), str(tmp_path), '--',
           '--device', 'cpu', 'with', 'margipose_model', 'synthetic', DESC,
           "train_datasets=['synthetic-16']", "val_datasets=['synthetic-4@1']", 'epochs=2',
           'batch_size=4', 'train_examples=8', 'val_examples=4', 'num_workers=0',
           'metrics_every=1', f'out_dir={out}']
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, 'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'torch.distributed: process 1/2 (gloo) on cpu' in proc.stdout

    (experiment_id,) = os.listdir(out)
    run_dir = out / experiment_id
    with open(run_dir / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert [r['epoch'] for r in records] == [0, 1]
    assert all(np.isfinite(r['val_loss']) for r in records)

    ranks = [torch.load(tmp_path / f'rank{r}.pt') for r in range(2)]
    assert [r['result']['experiment_id'] for r in ranks] == [experiment_id] * 2
    assert [r['result']['step'] for r in ranks] == [4, 4]  # 2 epochs of 8 / 4
    # the loss is the global batch's on both processes
    assert ranks[0]['result']['train_loss'] == ranks[1]['result']['train_loss']
    saved = ckpt.load_payload(str(run_dir / 'model-latest'))
    assert saved['step'] == 4
    for key, value in ranks[0]['model'].items():
        assert torch.equal(value, ranks[1]['model'][key]), key
        assert torch.equal(value, saved['model'][key]), key

    rows, stats = eval_3d.main(['--model', str(run_dir / 'model-latest'), '--dataset',
                                'synthetic-4', '--batch-size', '2', '--device', 'cpu'])
    assert len(rows['mpjpe']) == 4 and np.isfinite(stats['mean_loss'])


@pytest.fixture(scope='module')
def model_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('model') / 'model.pth')
    desc = small_desc(n_stages=1)
    save_model(path, create_model(desc, generator=torch.Generator().manual_seed(3)), desc)
    return path


def _eval(model_file, *extra):
    return eval_3d.main(['--model', model_file, '--dataset', 'synthetic-6', '--batch-size',
                         '4', '--device', 'cpu', *extra])


def test_eval_on_two_replicas_equals_one(model_file, capsys):
    rows1, stats1 = _eval(model_file, '--num-devices', '1')
    rows2, stats2 = _eval(model_file, '--num-devices', '2')
    assert 'Data-parallel eval over 2 devices' in capsys.readouterr().out
    assert len(rows2['mpjpe']) == 6 and stats2['batches'] == 2  # the tail batch padded
    for key in eval_3d.METRICS:
        np.testing.assert_allclose(rows2[key], rows1[key], rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(stats2['mean_loss'], stats1['mean_loss'], rtol=1e-6)


@pytest.mark.parametrize('extra,message', [
    (('--multicrop',), '--multicrop items are one example'),
    (('--batch-size', '3'), '--batch-size 3 must be divisible by --num-devices 2'),
], ids=['multicrop', 'indivisible'])
def test_num_devices_argument_errors(model_file, extra, message):
    with pytest.raises(SystemExit, match=message):
        _eval(model_file, '--num-devices', '2', *extra)


def test_num_devices_above_the_cards_exits(model_file, monkeypatch):
    """On a one-card machine, --num-devices 2 exits with the JAX bin's
    message before the model is read; 0 means every card."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(SystemExit, match=r'--num-devices 2 exceeds the 1 available device\(s\)'):
        eval_3d.main(['--model', model_file, '--num-devices', '2', '--batch-size', '4'])
    cuda = torch.device('cuda')
    assert eval_3d.eval_devices(0, cuda, 4, False) == [cuda]
    assert eval_3d.eval_devices(0, torch.device('cpu'), 4, False) == [torch.device('cpu')]
