"""The port stands alone: it imports nothing of JAX or of margipose_tpu, and
asking for CUDA where there is no card raises instead of falling back."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import margipose_tpu_torch
from margipose_tpu_torch import resolve_device

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'margipose_tpu')


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        margipose_tpu_torch.__path__, 'margipose_tpu_torch.'))


def _port_files():
    for dirpath, _, files in os.walk(os.path.join(ROOT, 'margipose_tpu_torch')):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith('.py'))
    yield os.path.join(ROOT, 'chip_smoke.py')


def _forbidden(name: str) -> bool:
    return name.split('.')[0] in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    """Nor matplotlib: only infer's PNG needs it, and it imports it there."""
    modules = _port_modules()
    for name in ('bin.eval_3d', 'bin.train_3d', 'bin.infer_single', 'bin.serve',
                 'bin.preprocess_mpi3d', 'ops.dsnt_jsd', 'ops.image', 'parallel.precision',
                 'data.mpi_inf_3dhp', 'data.mpi3d_raw', 'data.fake_mpi3d', 'data.mixed',
                 'data.h36m', 'data.mpii', 'data.fakes', 'data.mpi3d_preprocess',
                 'parallel.mesh'):
        assert f'margipose_tpu_torch.{name}' in modules
    code = (
        'import importlib, sys\n'
        f'for name in {modules!r}:\n'
        '    importlib.import_module(name)\n'
        f'bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN + ('matplotlib',)!r}]\n'
        'print(sorted(bad))\n'
    )
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, 'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


@pytest.mark.parametrize('path', sorted(_port_files()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{os.path.relpath(path, ROOT)}:{node.lineno} imports {bad}'


def test_forbidden_matches_exact_module_names():
    assert _forbidden('margipose_tpu') and _forbidden('margipose_tpu.ops.dsnt')
    assert _forbidden('jax.numpy')
    assert not _forbidden('margipose_tpu_torch.ops')


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device()
    assert resolve_device('cpu').type == 'cpu'


def test_eval_bin_defaults_to_cuda():
    from margipose_tpu_torch.bin.eval_3d import parse_args

    assert parse_args(['--model', 'x.pth']).device == 'cuda'


def test_infer_and_serve_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from margipose_tpu_torch.bin import infer_single, serve

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    # the device is resolved before the checkpoint is read
    with pytest.raises(RuntimeError, match='is_available'):
        infer_single.main(['--model', 'missing.pth', '--image', 'missing.jpg'])
    with pytest.raises(RuntimeError, match='is_available'):
        serve.create_server('missing.pth', warmup=False)
    with pytest.raises(RuntimeError, match='is_available'):
        serve.main(['--model', 'missing.pth', '--port', '0'])
