"""The port's ``margipose`` command against the JAX package's.

The dispatcher (``margipose_tpu_torch.bin.main``) has the JAX package's six
subcommands in its order; the global ``--device`` (default ``cuda``, and
``cuda`` without a card raises where the JAX package falls back to the CPU)
reaches each subcommand's ``func``, a subcommand's own ``--device`` takes
precedence, and ``python -m margipose_tpu_torch.bin --device cpu train ...``
then ``... eval`` run end to end: eval through the dispatcher prints the
tables that ``bin.eval_3d.main`` gives.
"""

import os
import subprocess
import sys

import pytest
import torch

import margipose_tpu.bin as jax_bin
import margipose_tpu.cli as jax_cli
import margipose_tpu_torch.bin as port_bin
from margipose_tpu_torch import cli
from margipose_tpu_torch.bin import eval_3d

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['gui', 'eval', 'train', 'hyperparams', 'infer', 'serve']


def _recording(monkeypatch):
    """Every subcommand's ``func`` replaced by a recorder of its calls."""
    calls = []
    for name, sub in port_bin._subcommands().items():
        monkeypatch.setattr(sub, 'func', lambda argv, opts, name=name: calls.append(
            (name, argv, opts)))
    return calls


def test_subcommands_match_the_jax_package():
    assert list(port_bin._subcommands()) == list(jax_bin._subcommands()) == NAMES
    for name, sub in port_bin._subcommands().items():
        assert sub.name == name and sub.help == jax_bin._subcommands()[name].help


@pytest.mark.parametrize('name', NAMES)
def test_device_cpu_reaches_the_subcommand(name, monkeypatch, capsys):
    calls = _recording(monkeypatch)
    port_bin.main(['margipose', '--device', 'cpu', name, '--flag', 'value'])
    assert calls == [(name, ['margipose', '--flag', 'value'], {'device': 'cpu'})]
    assert 'usage' not in capsys.readouterr().out


@pytest.mark.parametrize('name', NAMES)
def test_device_cuda_without_a_card_raises(name, monkeypatch):
    """The JAX package maps cuda to its CPU platform; the port raises, and
    the subcommand never runs."""
    jax_cli.apply_device_option('cuda')  # JAX's fall-back: no error
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = _recording(monkeypatch)
    with pytest.raises(RuntimeError, match='is_available'):
        port_bin.main(['margipose', '--device', 'cuda', name])
    with pytest.raises(RuntimeError, match='is_available'):
        port_bin.main(['margipose', name])  # the default is cuda
    assert calls == []


def test_a_subcommands_own_device_takes_precedence(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = _recording(monkeypatch)
    port_bin.main(['margipose', 'eval', '--model', 'm.pth', '--device', 'cpu'])
    port_bin.main(['margipose', 'train', '--device=cpu', 'with', 'quick'])
    assert calls == [('eval', ['margipose', '--model', 'm.pth', '--device', 'cpu'],
                      {'device': 'cpu'}),
                     ('train', ['margipose', '--device=cpu', 'with', 'quick'], {'device': 'cpu'})]


def test_bin_subcommand_hands_the_device_to_the_bins_flag():
    seen = []
    sub = cli.bin_subcommand('x', seen.append)
    sub.run(['prog', '--a', '1'], cli.create_common_arg_parser().parse_args(['--device', 'cpu']))
    assert seen == [['--device', 'cpu', '--a', '1']]


def test_no_subcommand_prints_usage(capsys):
    port_bin.main(['margipose'])
    out = capsys.readouterr().out
    assert out.startswith('usage: margipose') and '--device' in out


def test_every_entry_point_defaults_to_cuda():
    from margipose_tpu_torch.bin import export_model, hyperparam_search, run_gui, train_3d

    assert cli.create_common_arg_parser().parse_args([]).device == 'cuda'
    assert hyperparam_search.parse_args(['with', 'quick'])[0].device == 'cuda'
    assert train_3d.parse_args(['with', 'quick'])[0].device == 'cuda'
    assert run_gui.parse_args([]).device == 'cuda'
    assert export_model.parse_args(['prog', '-i', 'a', '-o', 'b']).device == 'cuda'


def _cli(*args, timeout=240):
    out = subprocess.run([sys.executable, '-m', 'margipose_tpu_torch.bin', *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, 'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_then_eval_through_the_dispatcher(tmp_path, capsys):
    _cli('--device', 'cpu', 'train', 'with', 'margipose_model', 'synthetic', 'sgd_simple',
         'epochs=1', 'batch_size=2', 'train_examples=2', 'val_examples=2', 'num_workers=0',
         'lr=0.01', "train_datasets=['synthetic-4']", "val_datasets=['synthetic-2@1']",
         "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}",
         f'out_dir={tmp_path}', 'experiment_id=cli')
    ckpt = str(tmp_path / 'cli' / 'model-latest')
    assert os.path.isdir(ckpt)
    args = ['--model', ckpt, '--dataset', 'synthetic-4', '--batch-size', '2']
    out = _cli('--device', 'cpu', 'eval', *args)
    rows, _ = eval_3d.main(args + ['--device', 'cpu'])
    tables = eval_3d.metric_tables(rows)
    assert '### Overall' in tables and tables in out
