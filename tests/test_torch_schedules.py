"""The port's schedules and optimisers against the JAX package's.

lr/momentum trajectories are held to ``margipose_tpu.train.schedules.
schedule_values``, and 6-step parameter trajectories of every
``make_optimiser`` algorithm to the optax transform the JAX package builds,
on a small tree of numpy parameters and gradients made from a seed. Both
sides are float32: atol 1e-6. The SGD update that reads lr and momentum on
the device is held to ``torch.optim.SGD`` over 20 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from margipose_tpu.train import schedules as jax_schedules
from margipose_tpu_torch.train.schedules import (
    ScheduledOptimiser,
    make_optimiser,
    schedule_values,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

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


# 20 steps: 1cycle's ramp up and down, two milestones of the multistep ones
LONG = dict(max_iters=20, milestones=[2, 4], gamma=0.5, steps_per_epoch=3)


def _torch_sgd_trajectory(opt, ref, params, ref_params, schedule, steps=20, seed=0):
    """``opt`` (a ScheduledOptimiser) and ``ref`` (torch.optim.SGD, its lr and
    momentum set from ``schedule`` on the host before each step) stepped on
    the same seeded gradients."""
    rng = np.random.RandomState(seed)
    for count in range(steps):
        for p, q in zip(params, ref_params):
            g = rng.randn(*p.shape).astype(np.float32)
            p.grad, q.grad = torch.from_numpy(g.copy()), torch.from_numpy(g)
        opt.step()
        lr, momentum = schedule(count)
        for group in ref.param_groups:
            group['lr'], group['momentum'] = lr, momentum
        ref.step()


def _start(seed=0):
    rng = np.random.RandomState(seed)
    values = [rng.randn(*s).astype(np.float32) for s in [(4, 3, 3, 3), (4,), (5, 7)]]
    return ([torch.from_numpy(v.copy()).requires_grad_() for v in values],
            [torch.from_numpy(v.copy()).requires_grad_() for v in values])


@pytest.mark.parametrize('algorithm', ['1cycle', 'sgd_simple', 'sgd', 'nesterov', 'weight_decay'])
def test_the_device_valued_update_is_torchs_sgd(algorithm):
    """``ScheduledOptimiser.update`` (lr and momentum read from 0-d tensors)
    against ``torch.optim.SGD`` over 20 steps, within float32 rounding: rtol
    1e-6 and 4e-6, two ulps at the trajectories' largest values (about 18),
    since torch's CPU step fuses p - lr d and ours rounds lr d first. The
    momentum buffers are torch's, in the optimiser's state; the hyperparameter
    sweep's SGD adds weight decay."""
    params, ref_params = _start(['1cycle', 'sgd_simple', 'sgd', 'nesterov',
                                 'weight_decay'].index(algorithm))
    if algorithm == 'weight_decay':
        def schedule(count):
            return schedule_values('1cycle', 0.5, count, **LONG)

        opt = ScheduledOptimiser(torch.optim.SGD(params, lr=0.05, momentum=0.9,
                                                 weight_decay=1e-2), schedule)
        ref = torch.optim.SGD(ref_params, lr=0.05, momentum=0.9, weight_decay=1e-2)
    else:
        def schedule(count):
            return schedule_values(algorithm, 0.5, count, **LONG)

        opt = make_optimiser(algorithm, params, 0.5, **LONG)
        ref = torch.optim.SGD(ref_params, lr=0.05, momentum=schedule(0)[1],
                              nesterov=algorithm == 'nesterov')
    assert opt.graphable
    _torch_sgd_trajectory(opt, ref, params, ref_params, schedule)
    assert opt.count == 20
    for p, q in zip(params, ref_params):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-6, atol=4e-6)
        got, want = opt.optimiser.state[p].get('momentum_buffer'), ref.state[q].get(
            'momentum_buffer')
        assert (got is None) == (want is None) == (algorithm in ('sgd_simple', 'sgd'))
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=4e-6)
    lr, momentum = opt._values
    assert lr.dtype == momentum.dtype == torch.float32 and lr.dim() == momentum.dim() == 0
    assert float(lr) == np.float32(schedule(19)[0]) and float(momentum) == np.float32(
        schedule(19)[1])


def test_the_graph_key_follows_load_state_dict_and_momentum():
    """SGD's key holds how often ``load_state_dict`` replaced the buffers
    and whether the update keeps momentum; an update leaves it as it was;
    RMSprop, which takes host values, has none."""
    params, _ = _start()
    opt = make_optimiser('1cycle', params, 0.5, **LONG)
    assert opt.graph_key() == (0, True)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()  # the first update makes the buffers
    assert opt.graph_key() == (0, True)
    opt.load_state_dict(opt.state_dict())
    assert opt.graph_key() == (1, True) and opt.generation == 1
    simple = make_optimiser('sgd_simple', params, 0.5, **LONG)
    assert simple.graph_key() == (0, False)
    rmsprop = make_optimiser('rmsprop', params, 0.5, **LONG)
    assert not rmsprop.graphable and rmsprop.graph_key() is None
