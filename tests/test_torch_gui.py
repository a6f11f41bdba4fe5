"""The port's GUI HTML report (``bin/run_gui.py``) against the JAX package's.

``run_gui.main --export-html`` renders ``synthetic-2`` with a calibrated JAX
MargiPose (2 stages, 64 px) carried across by ``state_dict_from_jax``. Each
example it processed is held against the JAX GUI's
``_load_and_process_example`` with the JAX model: predictions within 1e-4
(as tests/test_torch_margipose.py holds the coordinates), metrics within the
eval limits (MPJPE 0.1 mm, PCK and AUC 1e-3, aligned and not), heatmaps
within 1e-5. The HTML holds the markers tests/test_cli.py asserts of the
JAX report. Without a model, the ground-truth-only 3D pane equals JAX's.
"""

import jax
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.bin.run_gui as jax_gui
from margipose_tpu.data.get_dataset import get_dataset as jax_get_dataset
from margipose_tpu.models import data_specs_for_desc as jax_data_specs_for_desc
from margipose_tpu.models import default_data_specs as jax_default_data_specs
from margipose_tpu_torch.bin import run_gui
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


def _jax_results(desc, jax_model, variables, n):
    """The JAX GUI's results for the first ``n`` examples, with no model
    (and the default data specs, as the GUI takes them) where ``desc`` is
    None."""
    specs = jax_data_specs_for_desc(desc) if desc else jax_default_data_specs()
    dataset = jax_get_dataset('synthetic-2', specs, use_aug=False)
    forward = jax.jit(lambda x: jax_model.apply(variables, x, train=False)) if desc else None
    return [jax_gui._load_and_process_example(dataset, forward, i) for i in range(n)]


def _processed(monkeypatch):
    """Records every example the port's report processes."""
    seen, real = [], run_gui._load_and_process_example

    def spy(dataset, forward, index):
        seen.append(real(dataset, forward, index))
        return seen[-1]

    monkeypatch.setattr(run_gui, '_load_and_process_example', spy)
    return seen


@pytest.fixture(scope='module')
def model_file(tmp_path_factory):
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=5)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    path = str(tmp_path_factory.mktemp('gui') / 'model.pth')
    torch.save({'state_dict': model.state_dict(), 'model_desc': desc}, path)
    return path, desc, jax_model, variables


def test_html_report_matches_the_jax_gui(model_file, tmp_path, monkeypatch):
    path, desc, jax_model, variables = model_file
    seen = _processed(monkeypatch)
    out_file = str(tmp_path / 'report.html')
    run_gui.main(['--model', path, '--dataset', 'synthetic-2', '--export-html', out_file,
                  '--examples', '2', '--device', 'cpu'])
    want = _jax_results(desc, jax_model, variables, 2)
    assert len(seen) == 2
    for got, ref in zip(seen, want):
        assert_allclose(got['pred'], ref['pred'], atol=1e-4, rtol=0)
        for plane in ('xy', 'zy', 'xz'):
            assert_allclose(got['heatmaps'][plane], ref['heatmaps'][plane], atol=1e-5, rtol=0)
        assert got['metrics'].keys() == ref['metrics'].keys()
        for name, value in ref['metrics'].items():
            assert abs(got['metrics'][name] - value) <= (0.1 if 'mpjpe' in name else 1e-3), name
        assert_allclose(got['skel3d']['expected'], ref['skel3d']['expected'], atol=1e-9)

    html = open(out_file).read()
    assert 'MPJPE' in html and 'base64' in html
    n_joints = len(CanonicalSkeletonDesc.joint_names)
    assert f'hm-{n_joints - 1}' in html
    assert '<select id="joint">' in html
    assert CanonicalSkeletonDesc.joint_names[3] in html
    assert 'id="aligned"' in html and 'class="aligned"' in html
    assert '3D: prediction opaque, ground truth translucent' in html
    assert html.count('class="aligned"') >= 2  # metrics + aligned 3D pane


def test_report_without_a_model_shows_the_ground_truth(tmp_path, monkeypatch):
    seen = _processed(monkeypatch)
    out_file = str(tmp_path / 'gt.html')
    run_gui.main(['--dataset', 'synthetic-2', '--export-html', out_file, '--examples', '1',
                  '--device', 'cpu'])
    (want,) = _jax_results(None, None, None, 1)
    (got,) = seen
    assert got['pred'] is None and got['metrics'] is None and got['skel3d']['actual'] is None
    assert_allclose(got['skel3d']['expected'], want['skel3d']['expected'], atol=1e-9)
    html = open(out_file).read()
    assert 'base64' in html and 'MPJPE' not in html
