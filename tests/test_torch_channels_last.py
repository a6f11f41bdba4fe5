"""The channels-last train step (``train/steps.step_memory_format``) on the
CPU.

The rule: a graphed bf16 step (a batch on the card, no process group, no
mesh, a graphable optimiser) runs its model channels-last, every other step
NCHW; converting keeps the parameters the optimiser holds and moves its
momentum buffers to their layout. The models in either layout: a flagship
(2 stages, 64 px) and an integral model (64 px, D = 8) at float32 with the
plain batch norm give the same forward, loss, gradients and running
statistics channels-last as NCHW, every batch norm taking the channels-last
entry; ``permute_axis`` keeps its input's layout and its values; the loss
head and the soft-argmax get their inputs NCHW-contiguous. The kernels on
the card are ``tests/test_torch_batch_norm_kernel.py``'s and
``tests/test_torch_step_graph.py``'s (``-m cuda``).
"""

import copy
import types

import numpy as np
import pytest
import torch

from margipose_tpu_torch.models import create_model, integral, layers, margipose
from margipose_tpu_torch.models.layers import to_nchw
from margipose_tpu_torch.models.margipose import permute_axis
from margipose_tpu_torch.ops.batch_norm import channels_last
from margipose_tpu_torch.train import steps
from margipose_tpu_torch.train.schedules import make_optimiser
from margipose_tpu_torch.train.steps import (
    TrainState,
    graph_key,
    step_memory_format,
    to_memory_format,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

CL = torch.channels_last
FLAGSHIP = {'type': 'margipose', 'version': '6.0.1',
            'settings': {'n_stages': 2, 'axis_permutation': True,
                         'feature_extractor': 'inceptionv4', 'pixelwise_loss': 'jsd',
                         'input_size': 64}}
INTEGRAL = {'type': 'integral', 'version': '1.0.0',
            'settings': {'depth_dim': 8, 'input_size': 64}}


def _state(desc, seed=7, optimiser='1cycle'):
    model = create_model(desc, generator=torch.Generator().manual_seed(seed))
    return TrainState(model, make_optimiser(optimiser, model.parameters(), 1.0, max_iters=10,
                                            milestones=[1], gamma=0.1, steps_per_epoch=10))


def _batch(seed=0, batch=2, size=64):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(batch, 17)
    mask[0, [3, 9]] = 0
    return {'input': torch.randn(batch, 3, size, size, generator=g),
            'target': torch.rand(batch, 17, 3, generator=g) * 1.6 - 0.8,
            'joint_mask': mask, 'valid_depth': torch.tensor([1, 0, 1, 1][:batch])}


@pytest.mark.parametrize('on_card', [False, True], ids=['cpu', 'card'])
@pytest.mark.parametrize('dtype', [None, torch.float32, torch.bfloat16, 'bfloat16'],
                         ids=['none', 'float32', 'bfloat16', 'bf16-name'])
@pytest.mark.parametrize('group', [False, True], ids=['alone', 'group'])
@pytest.mark.parametrize('mesh', [None, 'mesh'], ids=['no-mesh', 'mesh'])
def test_the_format_rule(monkeypatch, on_card, dtype, group, mesh):
    """Channels-last only for a batch on the card, no group, no mesh, bf16."""
    if on_card:  # the CPU batch below stands for a card's
        monkeypatch.setattr(steps, 'GRAPH_DEVICES', ('cpu',))
    monkeypatch.setattr(steps, 'group_active', lambda: group)
    state = _state(INTEGRAL)
    key = graph_key('step', state, _batch(), None if mesh is None else types.SimpleNamespace())
    want = CL if (on_card and not group and mesh is None
                  and dtype in (torch.bfloat16, 'bfloat16')) else torch.contiguous_format
    assert step_memory_format(key, dtype) == want


def test_an_optimiser_that_cannot_be_graphed_keeps_nchw(monkeypatch):
    monkeypatch.setattr(steps, 'GRAPH_DEVICES', ('cpu',))
    state = _state(INTEGRAL, optimiser='rmsprop')
    assert step_memory_format(graph_key('step', state, _batch()), torch.bfloat16) == \
        torch.contiguous_format


def test_converting_keeps_the_parameters_and_moves_the_momentum_buffers():
    state = _state(INTEGRAL)
    params = list(state.model.parameters())
    values = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.randn_like(p)
    state.optimiser.step()  # makes the momentum buffers, NCHW
    bufs = {p: state.optimiser.optimiser.state[p]['momentum_buffer'].clone() for p in params}
    values = [p.detach().clone() for p in params]
    to_memory_format(state, CL)
    assert list(state.model.parameters()) == params  # the objects the optimiser holds
    four_d = [p for p in params if p.ndim == 4]
    assert four_d and all(p.is_contiguous(memory_format=CL) for p in four_d)
    for p, v in zip(params, values):
        assert torch.equal(p.detach(), v)
        buf = state.optimiser.optimiser.state[p]['momentum_buffer']
        assert buf.stride() == p.stride() and torch.equal(buf, bufs[p])
    to_memory_format(state, torch.contiguous_format)
    assert all(p.is_contiguous() for p in params)


def _run(model, batch, fmt):
    """Forward, loss and backward of ``model`` in layout ``fmt``, in
    float64 throughout (in float32 the gradients that are sums which cancel
    to nearly 0, a batch norm's bias under a softmax, come out as rounding
    noise in either layout); the batch norms' entries taken, by layout."""
    taken = []
    real = layers.batch_norm_train, layers.batch_norm_train_nhwc

    def spy(fn, name):
        def wrapped(x, *args):
            taken.append((name, channels_last(x)))
            return fn(x, *args)
        return wrapped

    model = model.to(torch.float64, memory_format=fmt).train()
    x = batch['input'].to(torch.float64, memory_format=fmt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, 'batch_norm_train', spy(real[0], 'nchw'))
        mp.setattr(layers, 'batch_norm_train_nhwc', spy(real[1], 'nhwc'))
        # MargiPose's heads in float64 too (the integral model's keep x's dtype)
        mp.setattr(margipose, 'to_nchw', lambda t, dtype=None: to_nchw(t))
        xyz, out = model(x)
        loss = model.masked_loss(out, batch['target'], batch['joint_mask'],
                                 batch['valid_depth'])
        loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return xyz.detach(), loss.detach(), grads, dict(model.named_buffers()), taken


@pytest.mark.parametrize('desc', [FLAGSHIP, INTEGRAL], ids=['flagship', 'integral'])
def test_the_models_give_the_same_numbers_channels_last(desc):
    """Forward, loss, every gradient and every running statistic within
    float32 rounding (1e-6 of the largest value) of the NCHW run's, both in
    float64 (the CPU's convolutions sum in another order in each layout);
    every batch norm takes the entry for its input's layout."""
    base = create_model(desc, generator=torch.Generator().manual_seed(3))
    batch = _batch(seed=5)
    want = _run(copy.deepcopy(base), batch, torch.contiguous_format)
    got = _run(copy.deepcopy(base), batch, CL)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in base.modules())
    assert want[4] == [('nchw', False)] * n_bn
    assert got[4] == [('nhwc', True)] * n_bn
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    largest = max(float(g.abs().max()) for g in want[2].values())
    for k, g in want[2].items():  # a gradient that is 0 but for rounding: 1e-9 of the largest
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[2][k].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6 * scale + 1e-9 * largest, err_msg=k)
    for k, b in want[3].items():
        np.testing.assert_allclose(got[3][k].double().numpy(), b.double().numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def _permute_axis_reference(x, mode):
    """``permute_axis`` written out element by element: group g of ``size``
    channels; channel s of the group swaps with width ('zy') or height
    ('xz')."""
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    for g in range(c // w):
        for s in range(w):
            if mode == 'zy':
                out[:, g * w + s] = x[:, g * w:(g + 1) * w, :, s].transpose(1, 2)
            else:
                out[:, g * w + s] = x[:, g * w:(g + 1) * w, s, :]
    return out


@pytest.mark.parametrize('mode', ['zy', 'xz'])
def test_permute_axis_keeps_nchw_for_nchw_input(mode):
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(1))
    y = permute_axis(x, mode)
    assert y.is_contiguous()
    assert torch.equal(y, _permute_axis_reference(x, mode))


@pytest.mark.parametrize('mode', ['zy', 'xz'])
def test_permute_axis_keeps_channels_last_and_its_values(mode):
    """The same values and the same gradient channels-last as NCHW."""
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(2))
    dy = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(3))
    xn = x.clone().requires_grad_()
    xc = x.contiguous(memory_format=CL).requires_grad_()
    yn, yc = permute_axis(xn, mode), permute_axis(xc, mode)
    assert channels_last(yc) and torch.equal(yc, yn)
    yn.backward(dy)
    yc.backward(dy.contiguous(memory_format=CL))
    assert channels_last(xc.grad) and torch.equal(xc.grad, xn.grad)
    assert permute_axis(xc, 'xy') is xc


def test_to_nchw_copies_channels_last_once_each_way():
    x = torch.randn(2, 6, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL)
    x.requires_grad_()
    y = to_nchw(x, torch.float32)
    assert y.is_contiguous() and y.dtype == torch.float32 and torch.equal(y, x.float())
    dy = torch.randn(2, 6, 4, 4)
    y.backward(dy)
    assert channels_last(x.grad) and x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, dy.to(torch.bfloat16))
    nchw = torch.randn(2, 6, 4, 4)
    assert to_nchw(nchw) is nchw


@pytest.mark.parametrize('desc, target, arg', [
    (FLAGSHIP, margipose, 'dsnt_jsd_grouped'), (INTEGRAL, integral, 'softargmax3d'),
], ids=['loss-head', 'soft-argmax'])
def test_the_heads_get_their_inputs_nchw_contiguous(monkeypatch, desc, target, arg):
    seen = []
    real = getattr(target, arg)

    def spy(first, *args, **kwargs):
        for t in (first if isinstance(first, (list, tuple)) else [first]):
            seen.append(t.is_contiguous())
        return real(first, *args, **kwargs)

    monkeypatch.setattr(target, arg, spy)
    model = create_model(desc, generator=torch.Generator().manual_seed(3))
    batch = _batch(seed=6)
    _run(model, batch, CL)
    assert seen and all(seen)


def test_the_eval_bin_takes_a_live_channels_last_model_as_an_nchw_copy(monkeypatch):
    """A bf16 train step leaves its live model channels-last; the eval bin
    (the soaks hand it the live state) evaluates an NCHW copy, as it would
    the checkpoint, and leaves the live model as it was."""
    from margipose_tpu_torch.bin import eval_3d

    seen = []
    real = eval_3d.make_forward

    def spy(model, *args, **kwargs):
        seen.append([p.is_contiguous() for p in model.parameters()])
        return real(model, *args, **kwargs)

    monkeypatch.setattr(eval_3d, 'make_forward', spy)
    desc = {**INTEGRAL, 'settings': {**INTEGRAL['settings'], 'depth_dim': 4}}
    live = create_model(desc, generator=torch.Generator().manual_seed(3)).to(memory_format=CL)
    argv = ['--model', 'live', '--dataset', 'synthetic-2', '--batch-size', '2', '--device', 'cpu']
    rows, _ = eval_3d.main(argv, model=(live, desc))
    assert any(channels_last(p) for p in live.parameters())  # the live model untouched
    nchw, _ = eval_3d.main(argv, model=(live.to(memory_format=torch.contiguous_format), desc))
    assert seen and all(all(s) for s in seen)
    assert all(np.array_equal(rows[m], nchw[m]) for m in rows)
