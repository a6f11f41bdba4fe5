"""The port's LR range test (``bin/hyperparam_search.py``) against the JAX
package's.

- ``LRCurveAccumulator`` gives the JAX class's curve and stop index on
  shared loss sequences, a divergence and a NaN among them.
- The lr each update applies equals the JAX bin's injected schedule
  (``lrs[clip(count, 0, max_iters - 1)]`` in float32), and the recorded lrs
  equal the JAX run's.
- A sweep of 4 iterations on ``synthetic-8`` at batch 2 (MargiPose, 1 stage,
  64 px) from the JAX run's initial variables, carried across by
  ``state_dict_from_jax``, is held against the JAX bin's
  ``run_lr_range_test(cfg)['losses']`` with the same cfg and seed; the JAX
  bin sizes its input by ``default_data_specs()``, which the test points at
  the model_desc's 64 px as the port's ``data_specs_for_desc`` does.

The sweep starts from calibrated weights (``test_torch_weights.
jax_margipose``), injected into the JAX run's ``create_train_state``: from
the raw Kaiming initialisation this sweep is so ill-conditioned that the
port's own float32 and float64 runs differ by 2.7% in the third
iteration's loss, while from calibrated weights they differ by at most
1.4e-3 (the fourth iteration's loss, after an update at lr 0.02).
``ema_beta=0`` records each iteration's raw loss, so no smoothing hides a
difference (the smoothing is the accumulator's, tested against JAX's
above). Tolerances:
  first loss    rtol 1e-4, as the train-step tests hold a loss: no update
                has been applied yet;
  later losses  rtol 3e-3: train-mode batch norm over 2 x 2 x 2 values a
                channel amplifies float32 reordering of each update (the
                JAX and port losses differed by at most 7.1e-4 relative
                here), and the port's own float32 run is 1.4e-3 from its
                float64 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.bin.hyperparam_search as jax_hp
from margipose_tpu.models import data_specs_for_desc as jax_data_specs_for_desc
from margipose_tpu_torch.bin import hyperparam_search as hp
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_weights import jax_margipose, small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

SEQUENCES = {
    'falling': [2.0, 1.8, 1.7, 1.5, 1.4, 1.35, 1.3, 1.2, 1.25, 1.1],
    'diverges': [1.0, 0.9, 0.8, 0.7, 0.9, 2.0, 8.0, 40.0, 300.0, 1e4],
    'nan': [1.0, 0.95, 0.9, float('nan'), 0.8],
    'inf': [1.0, 0.5, float('inf')],
    'non-positive': [0.0, -1.0, 5.0, 100.0, 1e3],
}


def _fold(cls, losses, beta):
    curve = cls(beta)
    stop = next((i for i, loss in enumerate(losses) if curve.add(i, loss)), None)
    return curve.smoothed, stop, curve.min_loss, curve.stopped


@pytest.mark.parametrize('beta', [0.99, 0.5])
@pytest.mark.parametrize('name', list(SEQUENCES))
def test_curve_accumulator_matches_jax(name, beta):
    got = _fold(hp.LRCurveAccumulator, SEQUENCES[name], beta)
    want = _fold(jax_hp.LRCurveAccumulator, SEQUENCES[name], beta)
    assert got == want
    if name in ('diverges', 'nan', 'inf'):
        assert got[1] is not None and got[3]


def test_each_update_applies_the_jax_schedules_lr():
    cfg = hp.ex.parse(['with', 'max_iters=5', 'lr_min=1e-4', 'lr_max=1.0', 'weight_decay=1e-4'])
    lrs = hp.sweep_lrs(cfg)
    assert_allclose(lrs, np.geomspace(1e-4, 1.0, 5), rtol=0)
    # the JAX bin's injected schedule (margipose_tpu/bin/hyperparam_search.py:103-104)
    jax_schedule = lambda count: jnp.asarray(lrs)[jnp.clip(count, 0, len(lrs) - 1).astype(int)]
    param = torch.nn.Parameter(torch.ones(3))
    opt = hp.make_sweep_optimiser([param], cfg, lrs)
    group = opt.optimiser.param_groups[0]
    assert group['weight_decay'] == 1e-4 and group['momentum'] == 0.9
    for count in range(len(lrs) + 3):
        param.grad = torch.ones(3)
        opt.step()
        assert group['lr'] == float(jax_schedule(count)), count


@pytest.fixture(scope='module')
def sweeps(tmp_path_factory):
    desc = small_desc(n_stages=1)
    words = ['with', 'synthetic', f'model_desc={desc!r}', "train_datasets=['synthetic-8']",
             'batch_size=2', 'max_iters=4', 'num_workers=0', 'ema_beta=0.0', 'lr_min=1e-3',
             'lr_max=1e-1', f'out_dir={tmp_path_factory.mktemp("hp")}']
    _, variables = jax_margipose(desc, seed=4)
    patch = pytest.MonkeyPatch()
    real = jax_hp.create_train_state
    patch.setattr(jax_hp, 'create_train_state', lambda model, rng, optimiser, input_shape: real(
        model, rng, optimiser, input_shape, variables=jax.tree.map(jnp.asarray, variables)))
    patch.setattr(jax_hp, 'default_data_specs', lambda: jax_data_specs_for_desc(desc))
    try:
        want = jax_hp.run_lr_range_test(jax_hp.ex.parse(words))
    finally:
        patch.undo()
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = hp.run_lr_range_test(hp.ex.parse(words), device='cpu', model=model)
    return got, want


def test_sweep_matches_jax(sweeps):
    got, want = sweeps
    assert got['lrs'] == want['lrs'] and len(got['lrs']) == 4
    assert len(got['losses']) == len(want['losses']) == 4
    assert_allclose(got['losses'][0], want['losses'][0], rtol=1e-4)
    assert_allclose(got['losses'][1:], want['losses'][1:], rtol=3e-3)
    assert len(got['step_seconds']) == 4


def test_sweep_writes_the_curve(sweeps):
    got, _ = sweeps
    table = np.loadtxt(f"{got['exp_dir']}/lr_curve.csv", delimiter=',')
    assert_allclose(table, np.stack([got['lrs'], got['losses']], 1), rtol=1e-15)
