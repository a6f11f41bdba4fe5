"""The port's bench (``margipose_tpu_torch/bench.py``) and its forward
(``train/steps.make_forward_fn``) on the CPU.

* ``make_forward_fn`` against the JAX package's ``make_forward_fn`` on the
  same numpy inputs: a JAX MargiPose (inceptionv4, 2 stages, 64 px, BN
  statistics randomised) exported into the port, batch 2, float32,
  ``atol=1e-5`` on the coordinates (float32 summation order; the
  coordinates lie in [-1, 1]). A (1, 1) mesh of one process gives what no
  mesh gives; a mesh with a 'model' axis over 1 refuses an unsharded model.
* The bench's function API at the small configuration: batch 2, a sweep of
  (2,), one timed call a segment, the reference child replaced by a stub
  line. One JSON line on stdout, with every key; the numbers finite, the
  ones only a card gives null on the CPU; ``vs_baseline`` the float32
  inference rate over the stub's.
* The reference's child process for real, at batch 1 on the CPU, with a
  ``tests`` package installed ahead of the checkout's on its path (the
  GPU machine the bench ran on has one): it runs the unedited
  ``bench_reference.py``.
* torch's FLOP count of the flagship's batch-1 forward against the 51.3
  GFLOP of XLA's cost analysis (``BASELINE.md``).
"""

import json
import math

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from margipose_tpu.train.steps import make_forward_fn as jax_make_forward_fn
from margipose_tpu_torch import bench
from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model
from margipose_tpu_torch.parallel.mesh import Mesh, make_mesh
from margipose_tpu_torch.train.steps import make_forward_fn
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

XLA_GFLOP = 51.3  # BASELINE.md, "North-star estimate": XLA's cost_analysis


@pytest.fixture(scope='module')
def pair():
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=0)
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_make_forward_fn(jax_model)(variables, x))
    return model, x, want


@pytest.mark.parametrize('mesh', [None, (1, 1)], ids=['no mesh', '(1, 1) mesh'])
def test_forward_matches_jax(pair, mesh):
    model, x, want = pair
    model.train()  # the forward puts it in eval mode
    forward = make_forward_fn(model, compute_dtype='float32',
                              mesh=None if mesh is None else make_mesh(mesh))
    xyz = forward(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert xyz.dtype == torch.float32 and xyz.shape == want.shape == (2, 17, 3)
    assert not xyz.requires_grad and not model.training
    assert_allclose(xyz.numpy(), want, atol=1e-5)


def test_forward_on_a_model_axis_needs_the_sharded_model(pair):
    hybrid = Mesh(shape={'data': 1, 'model': 2}, coords={'data': 0, 'model': 0})
    with pytest.raises(ValueError, match='shard_variables'):
        make_forward_fn(pair[0], mesh=hybrid)


def test_bench_prints_one_line_with_every_key(capsys):
    stub = {'infer_images_per_sec': 4.0, 'train_images_per_sec': 2.0}
    asked = []

    def reference(batch, device):
        asked.append((batch, device))
        return stub

    line, records = bench.run_bench('cpu', desc=small_desc(), batch=2, sweep=(2,), iters=1,
                                    reference=reference)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert tuple(line) == bench.LINE_KEYS
    assert asked == [(2, torch.device('cpu'))]
    card_only = {'mfu', 'train_mfu', 'peak_memory_gib', 'power_limit_w'}
    for key, value in line.items():
        if key in card_only:
            assert value is None, key
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            assert math.isfinite(value) and value > 0, (key, value)
    assert line['metric'] == bench.METRIC and line['precision'] == 'bfloat16'
    assert line['batch'] == 2 and line['device_name'] == 'cpu'
    assert isinstance(line['serve_link_bound'], bool)
    # the line rounds both rates (2 and 4 decimals); the ratio is of the unrounded one
    assert line['vs_baseline'] == pytest.approx(line['infer_images_per_sec_float32'] / 4.0,
                                                rel=1e-3)
    assert line['reference_infer_images_per_sec'] == 4.0
    assert line['reference_train_images_per_sec'] == 2.0
    assert line['serve_batch_occupancy'] == 2.0
    # 1 timed call after the first and 3 warm-ups; 2 warm-up train steps, then 1
    assert {k: r['calls'] for k, r in records.items()} == {
        'infer_float32': 5, 'infer_bfloat16': 5, 'infer_b1': 2, 'train_bfloat16': 3,
        'train_float32': 3, 'serve': 1 + 3 + 3}
    # on the CPU the loss head runs its plain version: nothing launches
    assert all(r['launches'] == {'dsnt_jsd_fwd': 0, 'dsnt_jsd_bwd': 0}
               for r in records.values())


def test_bench_refuses_a_sweep_without_its_batch():
    with pytest.raises(ValueError, match='base batch'):
        bench.run_bench('cpu', desc=small_desc(), batch=2, sweep=(4,), iters=1,
                        reference=None)


def test_the_reference_child_runs_the_unedited_script(tmp_path, monkeypatch):
    shadow = tmp_path / 'site' / 'tests'
    shadow.mkdir(parents=True)
    (shadow / '__init__.py').write_text('')
    monkeypatch.setenv('PYTHONPATH', str(shadow.parent))
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    result = bench.run_reference(1, torch.device('cpu'))
    assert result['device'] == 'cpu' and result['batch'] == 1
    assert result['torch_version'] == torch.__version__
    assert result['infer_images_per_sec'] > 0 and result['train_images_per_sec'] > 0


def test_flagship_flops_near_xla_count():
    """torch's ``FlopCounterMode`` counts 2 FLOPs a multiply-add of every
    convolution and transposed convolution (52.33 and 1.51 GFLOP here) and
    nothing else: no batch norm, activation or softmax. XLA's
    ``cost_analysis`` counts the optimised HLO program of the JAX model,
    whose three columns run as stacked, grouped convolutions and whose
    transposed convolutions are convolutions of a dilated input, and adds
    the elementwise work. So the two count different programs of one
    network, and agree within 6%: 53.84 against 51.3 GFLOP."""
    flops = bench.flops_per_image(Default_MargiPose_Desc)
    assert abs(flops / 1e9 - XLA_GFLOP) / XLA_GFLOP < 0.06, flops
    assert flops == pytest.approx(53.844598784e9, rel=1e-9)
