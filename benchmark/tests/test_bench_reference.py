"""The frozen references against the port, on the CPU at small sizes, from
one seeded state dict: what lets the references judge the port on the chip.
The port is imported here, in the test, never by ``benchmark/reference``."""

import numpy as np
import pytest
import torch

from benchmark import common, traffic, weights
from benchmark.drivers import train
from benchmark.reference import inputs, loss, sgd
from benchmark.tests.conftest import SMALL_MARGIPOSE

CPU = torch.device('cpu')


def _pair(config, seed=3):
    ref, state_dict = weights.seeded_reference(config, seed, CPU)
    port = common.port_model(config, {k: v.clone() for k, v in state_dict.items()}, CPU)
    return ref, port


def _images(config, n=2, seed=3):
    size = config['input_size']
    return inputs.normalise(torch.from_numpy(traffic.frames((n, size, size, 3), seed, 0)))


@pytest.mark.parametrize('name', ['margipose', 'chatterbox'])
def test_eval_forward_matches_the_port(name):
    config = SMALL_MARGIPOSE if name == 'margipose' else common.load_json(
        'configs', 'chatterbox-v1.3.0')
    ref, port = _pair(config)
    x = _images(config, n=1 if name == 'chatterbox' else 2)
    with torch.no_grad():
        r_xyz, r_hms = ref.eval()(x)
        p_xyz, p_out = port.eval()(x)
    assert torch.allclose(r_xyz, p_xyz, atol=1e-5)
    for plane, hms in zip(r_hms, p_out):
        for r, p in zip(plane, hms):
            assert torch.allclose(r, p, atol=1e-6)


def test_masked_loss_matches_the_port():
    from margipose_tpu_torch.models.margipose import margipose_masked_loss

    ref, port = _pair(SMALL_MARGIPOSE)
    x = _images(SMALL_MARGIPOSE)
    target = torch.empty(2, 17, 3).uniform_(-0.9, 0.9, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 17)
    mask[1, 3:7] = 0
    depth = torch.tensor([1, 0], dtype=torch.int32)
    with torch.no_grad():
        _, hms = ref.eval()(x)
        _, out = port.eval()(x)
    want = margipose_masked_loss(out, target, mask, depth, 'jsd')
    got = loss.masked_loss(hms, target, mask, depth)
    assert torch.allclose(got, want, rtol=1e-5)


def test_onecycle_sgd_matches_the_port():
    from margipose_tpu_torch.train.schedules import make_optimiser

    g = torch.Generator().manual_seed(2)
    a = torch.nn.Parameter(torch.randn(5, 4, generator=g))
    b = torch.nn.Parameter(a.detach().clone())
    port = make_optimiser('1cycle', [a], 1.0, max_iters=20)
    ref = sgd.OneCycleSGD([b], 1.0, 20)
    for _ in range(20):
        grad = torch.randn(5, 4, generator=g)
        a.grad, b.grad = grad.clone(), grad.clone()
        port.step()
        ref.step()
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def test_train_step_matches_the_port_in_float32():
    """Three float32 steps of the port's train step and the reference's, on
    the same seeded weights and batches: equal losses, coordinates, first
    gradient and change by leaf, to float32's reordering."""
    from margipose_tpu_torch.utils import init_algorithms

    from benchmark import compare
    from benchmark.tests.conftest import small_context

    ctx = small_context('margipose-train-bf16-b32', precision='float32')
    init_algorithms(deterministic=True)
    pool = traffic.batches(ctx.traffic, 17, ctx.seed)
    _, state_dict = weights.seeded_reference(ctx.config, ctx.seed, CPU)
    state_dict = {k: v.clone() for k, v in state_dict.items()}
    state, step, feed = train.program(ctx, state_dict, pool)
    got = train.judged_steps(state, step, feed, 3)
    want = train.reference_readout(train.reference_model(ctx.config, state_dict, CPU), pool,
                                   ctx.workload, CPU)
    readings, _ = compare.train_readings(got, want)
    assert compare.relative(got['losses'][:1], want['losses'][:1]) < 1e-5
    assert readings['loss_gap'] < 1e-3  # steps 2 and 3 amplify the first step's rounding
    assert readings['pred_gap'] < 1e-4
    assert readings['grad_gap'] < 1e-4
    assert readings['update_gap'] < 0.02  # three steps from a random start amplify rounding


def test_global_batch_step_is_one_step_over_the_rows():
    ref, _ = _pair(SMALL_MARGIPOSE)
    pool = traffic.batches({'batch': 4, 'pool': 1, 'frame': [64, 64], 'target_range': 0.9},
                           17, 1)
    feeds = [train._ref_feed(traffic.shard(pool, 2, i)[0], CPU) for i in range(2)]
    whole = train._ref_feed(pool[0], CPU)
    a = [p.detach().clone() for p in ref.parameters()]
    loss_a, _ = sgd.global_batch_step(ref, sgd.OneCycleSGD(ref.parameters(), 1.0, 10), feeds)
    after_a = [p.detach().clone() for p in ref.parameters()]
    with torch.no_grad():
        for p, v in zip(ref.parameters(), a):
            p.copy_(v)
    loss_b, _ = sgd.train_step(ref, sgd.OneCycleSGD(ref.parameters(), 1.0, 10), whole)
    assert float(loss_a) == float(loss_b)
    assert all(torch.equal(x, p) for x, p in zip(after_a, ref.parameters()))


def test_lower_precision_rounds():
    from benchmark.reference.lowp import round_fp8, round_tf32

    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    tf32 = (round_tf32(x) - x).abs() / x.abs()
    assert 0 < tf32.max() <= 2.0 ** -11
    fp8 = round_fp8(x)
    assert np.unique(fp8.numpy()).size < 256
