"""The port's schedules and optimisers against the JAX package's.

lr/momentum trajectories are held to ``margipose_tpu.train.schedules.
schedule_values``, and 6-step parameter trajectories of every
``make_optimiser`` algorithm to the optax transform the JAX package builds,
on a small tree of numpy parameters and gradients made from a seed. Both
sides are float32: atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from margipose_tpu.train import schedules as jax_schedules
from margipose_tpu_torch.train.schedules import make_optimiser, schedule_values

ALGORITHMS = ['1cycle', 'sgd_simple', 'sgd', 'nesterov', 'rmsprop']
# milestones at 2 and 4 steps (epochs of 2 steps); 1cycle over 6 steps
KWARGS = dict(max_iters=6, milestones=[1, 2], gamma=0.5, steps_per_epoch=2)
LR = {'1cycle': 0.5, 'sgd_simple': 0.2, 'sgd': 0.2, 'nesterov': 0.2, 'rmsprop': 2.5e-3}


@pytest.mark.parametrize('algorithm', ALGORITHMS)
def test_schedule_values_match_jax(algorithm):
    kwargs = dict(max_iters=1000, milestones=[80, 140], gamma=0.1, steps_per_epoch=5)
    for step in [0, 1, 2, 399, 400, 404, 449, 699, 700, 701, 899, 950, 999, 1005]:
        got = schedule_values(algorithm, 1.0, step, **kwargs)
        expected = jax_schedules.schedule_values(algorithm, 1.0, step, **kwargs)
        np.testing.assert_allclose(got, expected, rtol=1e-6, err_msg=f'{algorithm} step {step}')


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match='adamw'):
        make_optimiser('adamw', [torch.zeros(1, requires_grad=True)], 0.1)


@pytest.mark.parametrize('algorithm', ALGORITHMS)
def test_parameter_trajectory_matches_optax(algorithm):
    rng = np.random.RandomState(ALGORITHMS.index(algorithm))
    shapes = {'conv': (4, 3, 3, 3), 'bn': (4,), 'fc': (5, 7)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]

    tx = jax_schedules.make_optimiser(algorithm, LR[algorithm], **KWARGS)
    jax_params = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jax_params)
    torch_params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = make_optimiser(algorithm, list(torch_params.values()), LR[algorithm], **KWARGS)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        assert opt.count == step + 1
        for k, p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[k]), atol=1e-6,
                                       err_msg=f'{algorithm} step {step} {k}')


def test_state_dict_round_trip_continues_the_trajectory():
    rng = np.random.RandomState(9)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(4)]
    start = rng.randn(3, 4).astype(np.float32)

    def run(steps, restore=None):
        p = torch.from_numpy(start.copy()).requires_grad_()
        opt = make_optimiser('1cycle', [p], 0.5, **KWARGS)
        if restore is not None:
            p.data.copy_(restore[0])
            opt.load_state_dict(restore[1])
        for g in grads[opt.count:steps]:
            p.grad = torch.from_numpy(g)
            opt.step()
        return p.detach().clone(), opt.state_dict()

    straight, _ = run(4)
    half = run(2)
    resumed, state = run(4, restore=half)
    assert state['count'] == 4
    assert torch.equal(straight, resumed)
