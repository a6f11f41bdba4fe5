"""The port's model exporter (``bin/export_model.py``) against the JAX
package's, in round trips across the two packages:

- the JAX package's ``export_model -f torch`` of an orbax checkpoint loads
  into the port (``checkpoint.load_model``, strict) with every tensor equal
  bit for bit;
- the port's ``-f torch`` loads into the JAX package
  (``train.checkpoint.load_model``) with every variable equal bit for bit;
- the port's ``-f native`` (a weights-only train-state directory) loads
  back bit for bit;
- the port's ``-f export`` (``torch.export``) loads back, and its
  coordinates equal the model's eval forward within 1e-6 on the CPU.

The model is a calibrated JAX MargiPose (1 stage, 64 px).
"""

import jax
import numpy as np
import pytest
import torch

import margipose_tpu.bin.export_model as jax_export_model
from margipose_tpu.train import checkpoint as jax_checkpoint
from margipose_tpu_torch.bin import export_model
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def source(tmp_path_factory):
    """(model_desc, JAX variables, the port's reference-format .pth of them)."""
    desc = small_desc(n_stages=1)
    _, variables = jax_margipose(desc, seed=6)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    pth = str(tmp_path_factory.mktemp('src') / 'model.pth')
    torch.save({'state_dict': model.state_dict(), 'model_desc': desc}, pth)
    return desc, variables, pth


def _export(src, out, fmt):
    export_model.main(['export_model', '-i', src, '-o', str(out), '-f', fmt, '--device', 'cpu'])


def _assert_state_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_jax_torch_export_loads_into_the_port(source, tmp_path):
    desc, variables, _ = source
    ckpt = str(tmp_path / 'orbax')
    jax_checkpoint.save_model(ckpt, variables, desc)
    pth = str(tmp_path / 'from_jax.pth')
    jax_export_model.main(['export_model', '-i', ckpt, '-o', pth, '-f', 'torch'])
    model, model_desc = load_model(pth, 'cpu')
    assert model_desc == desc
    _assert_state_dicts_equal(model.state_dict(), state_dict_from_jax(variables))
    _assert_state_dicts_equal(model.state_dict(), torch.load(pth)['state_dict'])


def test_port_torch_export_loads_into_jax(source, tmp_path):
    desc, variables, pth = source
    out = tmp_path / 'to_jax.pth'
    _export(pth, out, 'torch')
    saved = torch.load(out)
    assert saved['train_datasets'] == [] and saved['epoch'] == 0
    _, got, model_desc = jax_checkpoint.load_model(str(out))
    assert model_desc == desc
    want_leaves = jax.tree_util.tree_leaves_with_path(variables)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        g = np.asarray(g)
        assert g.dtype == w.dtype and np.array_equal(g, w), jax.tree_util.keystr(path)


def test_port_native_export_round_trips(source, tmp_path):
    desc, _, pth = source
    out = tmp_path / 'native'
    _export(pth, out, 'native')
    model, model_desc = load_model(str(out), 'cpu')
    assert model_desc == desc
    _assert_state_dicts_equal(model.state_dict(), torch.load(pth)['state_dict'])


def test_port_program_export_matches_the_eager_forward(source, tmp_path):
    desc, _, pth = source
    out = tmp_path / 'model.pt2'
    _export(pth, out, 'export')
    program = torch.export.load(str(out)).module()
    model, _ = load_model(pth, 'cpu')
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 64, 64).astype(np.float32))
    with torch.inference_mode():
        want = model(x)[0]
        got = program(x)
    assert got.shape == (1, 17, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
