"""Train-mode batch norm (``ops/batch_norm.py``, ``csrc/batch_norm.cu``).

On the CPU: ``models/layers.BatchNorm2d`` routes train mode with no process
group to ``batch_norm_train``, whose CPU path gives the bits the module gave
before the kernels (torch's batch norm, then the running-variance fix-up);
eval mode and an active group keep their own paths; the wrapper's argument
checks and the launch plan at every batch-norm shape of the train cells.
The ``cuda``-marked cases hold the kernels against the plain version on the
card (``-m cuda``) and skip without one."""

import numpy as np
import pytest
import torch
from torch import nn

from margipose_tpu_torch.models import layers
from margipose_tpu_torch.models.layers import BatchNorm2d
from margipose_tpu_torch.ops import batch_norm as bn
from margipose_tpu_torch.ops import launch_counts

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

# (C, H * W, batch norms) at batch 32: the flagship's, then the integral
# model's, with the plan each way in bf16 (forward, backward) and float32
FLAGSHIP = [(192, 256, 180), (128, 1024, 145), (17, 1024, 36), (96, 1024, 5), (64, 4096, 4),
            (96, 4096, 3), (32, 16384, 2), (64, 1024, 2), (64, 16384, 1), (192, 1024, 1)]
INTEGRAL = [(256, 256, 12), (128, 1024, 7), (1024, 256, 7), (64, 4096, 6), (256, 4096, 5),
            (512, 1024, 5), (512, 64, 5), (2048, 64, 4), (256, 1024, 2), (64, 16384, 1),
            (128, 4096, 1), (512, 256, 1)]
PLANS = {  # (C, H * W): (bf16 forward, bf16 backward, float32 forward, float32 backward)
    (192, 256): (('cluster', 2), ('cluster', 2), ('cluster', 2), ('cluster', 2)),
    (128, 1024): (('cluster', 4), ('cluster', 4), ('cluster', 4), ('cluster', 4)),
    (17, 1024): (('cluster', 8), ('cluster', 8), ('cluster', 8), ('cluster', 8)),
    (96, 1024): (('cluster', 4), ('cluster', 4), ('cluster', 4), ('cluster', 4)),
    (64, 4096): (('cluster', 8), ('cluster', 8), ('cluster', 8), ('cluster', 8)),
    (96, 4096): (('cluster', 4), ('cluster', 8), ('cluster', 8), ('cluster', 8)),
    (32, 16384): (('cluster', 8), ('split', 32), ('split', 64), ('split', 64)),
    (64, 1024): (('cluster', 8), ('cluster', 8), ('cluster', 8), ('cluster', 8)),
    (64, 16384): (('cluster', 8), ('split', 32), ('split', 64), ('split', 64)),
    (192, 1024): (('cluster', 2), ('cluster', 2), ('cluster', 2), ('cluster', 4)),
    (256, 256): (('cluster', 2), ('cluster', 2), ('cluster', 2), ('cluster', 2)),
    (1024, 256): (('cluster', 1), ('cluster', 1), ('cluster', 1), ('cluster', 1)),
    (256, 4096): (('cluster', 4), ('cluster', 8), ('cluster', 8), ('cluster', 8)),
    (512, 1024): (('cluster', 1), ('cluster', 2), ('cluster', 2), ('cluster', 4)),
    (512, 64): (('cluster', 1), ('cluster', 1), ('cluster', 1), ('cluster', 1)),
    (2048, 64): (('cluster', 1), ('cluster', 1), ('cluster', 1), ('cluster', 1)),
    (256, 1024): (('cluster', 2), ('cluster', 2), ('cluster', 2), ('cluster', 4)),
    (128, 4096): (('cluster', 4), ('cluster', 8), ('cluster', 8), ('cluster', 8)),
    (512, 256): (('cluster', 1), ('cluster', 1), ('cluster', 1), ('cluster', 1)),
}
CHUNK_SMEM = 48 * 1024  # kMaxChunkBytes: a split forward chunk's shared memory
PLANS_NHWC = {  # (C, H * W): channels-last, as PLANS
    (192, 256): (('cluster', 2, 8), ('cluster', 2, 8), ('cluster', 4, 8), ('cluster', 4, 8)),
    (128, 1024): (('cluster', 2, 8), ('split', 16, 132), ('split', 32, 132), ('split', 32, 132)),
    (17, 1024): (('split', 8, 88), ('split', 8, 88), ('split', 4, 53), ('split', 4, 53)),
    (96, 1024): (('cluster', 2, 8), ('split', 4, 88), ('cluster', 2, 8), ('split', 8, 88)),
    (64, 4096): (('split', 8, 132), ('split', 8, 132), ('split', 16, 132), ('split', 16, 132)),
    (96, 4096): (('split', 4, 88), ('split', 4, 88), ('split', 8, 88), ('split', 8, 88)),
    (32, 16384): (('split', 4, 132), ('split', 4, 132), ('split', 8, 132), ('split', 8, 132)),
    (64, 1024): (('cluster', 2, 8), ('split', 8, 132), ('cluster', 2, 8), ('split', 16, 132)),
    (64, 16384): (('split', 8, 132), ('split', 8, 132), ('split', 16, 132), ('split', 16, 132)),
    (192, 1024): (('cluster', 2, 8), ('split', 8, 88), ('split', 16, 88), ('split', 16, 88)),
    (256, 256): (('cluster', 4, 8), ('cluster', 4, 8), ('cluster', 8, 8), ('split', 32, 132)),
    (1024, 256): (('split', 32, 66), ('split', 32, 66), ('split', 32, 33), ('split', 32, 33)),
    (256, 4096): (('split', 32, 132), ('split', 32, 132), ('split', 32, 132), ('split', 32, 132)),
    (512, 1024): (('split', 32, 132), ('split', 32, 132), ('split', 32, 66), ('split', 32, 66)),
    (512, 64): (('cluster', 2, 2), ('cluster', 2, 2), ('cluster', 4, 2), ('cluster', 4, 2)),
    (2048, 64): (('cluster', 8, 2), ('split', 32, 33), ('split', 32, 17), ('split', 32, 17)),
    (256, 1024): (('split', 32, 132), ('split', 32, 132), ('split', 32, 132), ('split', 32, 132)),
    (128, 4096): (('split', 16, 132), ('split', 16, 132), ('split', 32, 132), ('split', 32, 132)),
    (512, 256): (('cluster', 8, 8), ('split', 32, 132), ('split', 32, 66), ('split', 32, 66)),
}


class _OldBatchNorm2d(nn.BatchNorm2d):
    """The module's train mode before the kernels: torch's batch norm, then
    the fix-up of its unbiased running variance."""

    def forward(self, x):
        old = self.running_var.clone()
        out = super().forward(x)
        n = x.numel() // x.shape[1]
        var = self.running_var.data
        if self.momentum is None:
            keep = 1.0 - 1.0 / self.num_batches_tracked.to(self.running_var.dtype)
        else:
            keep = 1.0 - self.momentum
        var.sub_((var - keep * old) / n)
        return out


def _pair(c, momentum, eps, seed):
    rng = np.random.RandomState(seed)
    mods = BatchNorm2d(c, eps=eps, momentum=momentum), _OldBatchNorm2d(c, eps=eps,
                                                                       momentum=momentum)
    state = {'weight': rng.uniform(0.5, 1.5, c), 'bias': rng.randn(c) * 0.1,
             'running_mean': rng.randn(c) * 0.1, 'running_var': rng.uniform(0.5, 1.5, c)}
    for m in mods:
        with torch.no_grad():
            for k, v in state.items():
                getattr(m, k).copy_(torch.from_numpy(v.astype(np.float32)))
    return mods


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('momentum', [0.1, None])
def test_cpu_train_mode_gives_the_old_bits(dtype, momentum):
    """Two train passes: outputs, gradients, running statistics and the
    counter bit for bit those of torch's batch norm plus the fix-up."""
    ours, old = _pair(6, momentum, 1e-3, seed=0)
    rng = np.random.RandomState(1)
    for step in range(2):
        x = torch.from_numpy((rng.randn(3, 6, 5, 7) * 2 + 0.5).astype(np.float32)).to(dtype)
        dy = torch.from_numpy(rng.randn(3, 6, 5, 7).astype(np.float32)).to(dtype)
        got, want = [], []
        for m, out in ((ours, got), (old, want)):
            xr = x.clone().requires_grad_()
            y = m.train()(xr)
            y.backward(dy)
            out += [y, xr.grad, m.weight.grad, m.bias.grad]
            m.zero_grad()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for k in ('running_mean', 'running_var', 'num_batches_tracked'):
            assert torch.equal(getattr(ours, k), getattr(old, k)), (step, k)


def test_the_in_place_relu_after_a_batch_norm_keeps_its_gradient():
    """y is not saved for the backward: relu_ on it, as BasicConv2d does."""
    ours, old = _pair(4, 0.1, 1e-5, seed=2)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 4, 3, 3).astype(np.float32))
    grads = []
    for m in (ours, old):
        xr = x.clone().requires_grad_()
        m.train()(xr).relu_().square().sum().backward()
        grads.append(xr.grad)
    assert torch.equal(*grads)


def test_eval_mode_is_torchs_own(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('eval mode reached batch_norm_train')

    monkeypatch.setattr(layers, 'batch_norm_train', refuse)
    ours, old = _pair(5, 0.1, 1e-5, seed=4)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 5, 4, 4).astype(np.float32))
    assert torch.equal(ours.eval()(x), nn.BatchNorm2d.forward(old.eval(), x))
    assert int(ours.num_batches_tracked) == 0


def test_an_active_group_takes_the_global_batch_norm(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a group reached batch_norm_train')

    monkeypatch.setattr(layers, 'batch_norm_train', refuse)
    monkeypatch.setattr(layers.mesh, 'group_active', lambda: True)
    seen = []
    monkeypatch.setattr(BatchNorm2d, '_global_forward', lambda self, x: seen.append(x) or x)
    x = torch.zeros(2, 3, 2, 2)
    assert BatchNorm2d(3).train()(x) is x and seen == [x]


def test_train_mode_without_a_group_takes_batch_norm_train(monkeypatch):
    calls = []
    real = layers.batch_norm_train

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(layers, 'batch_norm_train', spy)
    m = BatchNorm2d(3, eps=1e-3, momentum=None)
    m.train()(torch.ones(2, 3, 2, 2))
    (x, weight, bias, mean, var, tracked, momentum, eps), = calls
    assert weight is m.weight and bias is m.bias and mean is m.running_mean
    assert var is m.running_var and tracked is m.num_batches_tracked
    assert momentum is None and eps == 1e-3


@pytest.mark.parametrize('make, error', [
    (lambda: torch.zeros(2, 3, 4, 4, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(2, 3, 4, 4, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(2, 3, 4, 4).to(memory_format=torch.channels_last), ValueError),
    (lambda: torch.zeros(2, 3, 4, 4)[:, :, :, :2], ValueError),
    (lambda: torch.zeros(2, 3, 16), ValueError),
    (lambda: torch.zeros(1, 3, 1, 1), ValueError),
    (lambda: torch.empty(1, 70000, 1, 2, device='meta'), ValueError),
    (lambda: torch.empty(2 ** 16, 1, 2 ** 8, 2 ** 7, device='meta'), ValueError),
])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(make, error):
    with pytest.raises(error):
        bn.check_input(make())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_wrapper_takes_nchw_float32_and_bf16(dtype):
    assert bn.check_input(torch.zeros(2, 3, 4, 5, dtype=dtype)) == (2, 3, 20)
    assert bn.check_input(torch.zeros(1, 3, 1, 2, dtype=dtype)) == (1, 3, 2)


@pytest.mark.parametrize('name, tensor', [
    ('weight', torch.ones(3, dtype=torch.bfloat16)),
    ('weight', torch.ones(4)),
    ('running_var', torch.ones(6)[::2]),
    ('save_mean', torch.ones(3, 1)),
])
def test_the_per_channel_tensors_must_be_float32_vectors(name, tensor):
    x = torch.zeros(2, 3, 4, 4)
    bn.check_stats(x, **{name: torch.ones(3)})
    with pytest.raises(ValueError, match=name):
        bn.check_stats(x, **{name: tensor})


@pytest.mark.parametrize('shape, dtype, offset, per', [
    ((2, 3, 4, 4), torch.bfloat16, 0, 8), ((2, 3, 4, 4), torch.float32, 0, 4),
    ((2, 3, 2, 2), torch.float32, 0, 4), ((2, 3, 2, 2), torch.bfloat16, 0, 1),
    ((2, 3, 7, 9), torch.float32, 0, 1), ((2, 3, 4, 4), torch.float32, 1, 1),
])
def test_a_thread_takes_16_bytes_where_planes_and_pointers_allow(shape, dtype, offset, per):
    n = int(np.prod(shape))
    x = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    assert bn.vector_values(x) == per


@pytest.mark.parametrize('c, plane, layers', FLAGSHIP + INTEGRAL,
                         ids=[f'{c}x{p}' for c, p, _ in FLAGSHIP + INTEGRAL])
def test_the_plan_at_the_train_cells_shapes(c, plane, layers):
    got = tuple(bn.plan(c, 32 * plane, width, tensors)
                for width in (2, 4) for tensors in (1, 2))
    assert got == PLANS[(c, plane)]


def test_the_cells_tables_count_their_batch_norms():
    assert sum(n for _, _, n in FLAGSHIP) == 379
    assert sum(n for _, _, n in INTEGRAL) == 56


@pytest.mark.parametrize('width, tensors', [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_every_plan_fits_the_kernels_limits(width, tensors):
    """What csrc/batch_norm.cu's setup accepts: a cluster of at most 8
    blocks, each slice at most 128 KB of shared memory; a split forward's
    chunk within 48 KB; never more blocks a channel than vectors."""
    rng = np.random.RandomState(width * 10 + tensors)
    for _ in range(400):
        c = int(rng.randint(1, 4096))
        count = int(rng.choice([2, 3, 17, 64, 1000, 8192, 32768, 131072, 524288, 2 ** 21]))
        per = int(rng.choice([1, 16 // width]))
        count -= count % per or 0
        if count < 2:
            continue
        kind, parts = bn.plan(c, count, width, tensors, per)
        vectors = count // per
        assert 1 <= parts <= vectors
        slice_bytes = -(-vectors // parts) * per * width
        if kind == 'cluster':
            assert parts in (1, 2, 4, 8) and slice_bytes * tensors <= bn.MAX_SLICE_BYTES
        else:
            assert kind == 'split' and slice_bytes <= CHUNK_SMEM
            assert (-(-vectors // 8)) * per * width * tensors > bn.MAX_SLICE_BYTES


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize('make, error', [
    (lambda: _cl(torch.zeros(2, 3, 4, 4, dtype=torch.float16)), TypeError),
    (lambda: _cl(torch.zeros(2, 3, 4, 4, dtype=torch.float64)), TypeError),
    (lambda: torch.zeros(2, 3, 4, 4), ValueError),
    (lambda: _cl(torch.zeros(2, 3, 4, 4))[:, :2], ValueError),
    (lambda: torch.zeros(2, 3, 16), ValueError),
    (lambda: _cl(torch.zeros(1, 3, 1, 1)), ValueError),
    (lambda: torch.empty(1, 70000, 1, 2, device='meta').contiguous(
        memory_format=torch.channels_last), ValueError),
    (lambda: torch.empty(2 ** 16, 1, 2 ** 8, 2 ** 7, device='meta'), ValueError),
])
def test_the_nhwc_wrapper_refuses_what_its_kernels_do_not_take(make, error):
    with pytest.raises(error):
        bn.check_input_nhwc(make())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_nhwc_wrapper_takes_channels_last_float32_and_bf16(dtype):
    assert bn.check_input_nhwc(_cl(torch.zeros(2, 3, 4, 5, dtype=dtype))) == (40, 3)
    assert bn.check_input_nhwc(_cl(torch.zeros(1, 17, 1, 2, dtype=dtype))) == (2, 17)


@pytest.mark.parametrize('shape, dtype, offset, per', [
    ((2, 16, 3, 3), torch.bfloat16, 0, 8), ((2, 8, 3, 3), torch.float32, 0, 4),
    ((2, 17, 4, 4), torch.bfloat16, 0, 1), ((2, 6, 4, 4), torch.float32, 0, 1),
    ((2, 8, 4, 4), torch.float32, 1, 1),
])
def test_an_nhwc_thread_takes_16_bytes_where_rows_and_pointers_allow(shape, dtype, offset, per):
    b, c, h, w = shape
    x = torch.zeros(b * c * h * w + offset, dtype=dtype)[offset:].view(b, h, w, c)
    assert bn.vector_values_nhwc(x.permute(0, 3, 1, 2)) == per


@pytest.mark.parametrize('c, plane, layers', FLAGSHIP + INTEGRAL,
                         ids=[f'{c}x{p}' for c, p, _ in FLAGSHIP + INTEGRAL])
def test_the_nhwc_plan_at_the_train_cells_shapes(c, plane, layers):
    got = tuple(bn.plan_nhwc(c, 32 * plane, width, tensors,
                             16 // width if c % (16 // width) == 0 else 1)
                for width in (2, 4) for tensors in (1, 2))
    assert got == PLANS_NHWC[(c, plane)]


@pytest.mark.parametrize('width, tensors', [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_every_nhwc_plan_fits_the_kernels_limits(width, tensors):
    """What csrc/batch_norm.cu's setup_nhwc accepts: tc a power of two up
    to 32, at most 65535 groups, never more parts than rows; a cluster of
    at most 8 blocks, each holding at most 128 KB of its group's rows, and
    only over 16-byte vectors; any parts for the split path."""
    rng = np.random.RandomState(width * 10 + tensors + 100)
    for _ in range(400):
        c = int(rng.choice([1, 3, 8, 17, 24, 64, 96, 192, 256, 1000, 2048, 4096]))
        rows = int(rng.choice([2, 3, 17, 64, 1000, 8192, 32768, 131072, 524288, 2 ** 21]))
        per = int(rng.choice([1, 16 // width]))
        if c % per:
            per = 1
        kind, tc, parts = bn.plan_nhwc(c, rows, width, tensors, per)
        cols = c // per
        assert tc in (1, 2, 4, 8, 16, 32) and 1 <= parts <= rows
        assert -(-cols // tc) <= 65535
        if kind == 'cluster':
            assert parts in (1, 2, 4, 8) and per * width == 16
            assert -(-rows // parts) * tc * per * width * tensors <= bn.MAX_SLICE_BYTES
        else:
            assert kind == 'split'


@pytest.mark.parametrize('fmt, entry', [(torch.contiguous_format, 'batch_norm_train'),
                                        (torch.channels_last, 'batch_norm_train_nhwc')],
                         ids=['nchw', 'channels-last'])
def test_train_mode_routes_by_the_inputs_layout(monkeypatch, fmt, entry):
    calls = []
    for name in ('batch_norm_train', 'batch_norm_train_nhwc'):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name,
                            lambda *args, _n=name, _r=real: calls.append(_n) or _r(*args))
    m = BatchNorm2d(3).train()
    x = torch.randn(2, 3, 4, 4).contiguous(memory_format=fmt)
    y = m(x)
    assert calls == [entry] and y.is_contiguous(memory_format=fmt)
    # the CPU's channels-last batch norm sums in another order
    want = nn.BatchNorm2d.forward(BatchNorm2d(3).train(), x.contiguous())
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-6)


def test_a_tensor_both_layouts_hold_routes_to_the_nchw_kernels():
    """C = 1 or H * W = 1: the same memory either way, the NCHW entry."""
    for shape in ((2, 1, 3, 3), (4, 5, 1, 1)):
        x = torch.zeros(shape).contiguous(memory_format=torch.channels_last)
        assert x.is_contiguous() and not bn.channels_last(x)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the batch-norm kernels have no CPU mode)')
    return torch.device('cuda')


def _run(fn, x, dy, params, momentum, eps=1e-3):
    weight, bias = (p.clone().requires_grad_() for p in params[:2])
    mean, var = (p.clone() for p in params[2:])
    tracked = torch.zeros((), dtype=torch.long, device=x.device)
    xr = x.detach().requires_grad_()
    y = fn(xr, weight, bias, mean, var, tracked, momentum, eps)
    y.backward(dy)
    return {'y': y.detach(), 'dx': xr.grad, 'dw': weight.grad, 'db': bias.grad,
            'running_mean': mean, 'running_var': var, 'tracked': tracked}


CARD_SHAPES = [(32, 192, 16, 16), (32, 128, 32, 32), (32, 64, 128, 128), (32, 2048, 8, 8),
               (2, 6, 7, 9)]


def _exact(x, dy, params, momentum, eps=1e-3):
    """The outputs in float64 from the same inputs, one step from a reset
    counter."""
    weight, bias, mean, var = (p.double() for p in params)
    xf, dyf, dims = x.double(), dy.double(), (0, 2, 3)
    n = x.numel() // x.shape[1]
    mu, v = xf.mean(dims), xf.var(dims, unbiased=False)
    invstd = 1 / (v + eps).sqrt()
    xhat = (xf - mu[:, None, None]) * invstd[:, None, None]
    f = 1.0 if momentum is None else momentum
    sdy, sdx = dyf.sum(dims), (dyf * xhat).sum(dims)
    return {'y': xhat * weight[:, None, None] + bias[:, None, None],
            'dx': (weight * invstd)[:, None, None] * (dyf - (sdy / n)[:, None, None]
                                                      - xhat * (sdx / n)[:, None, None]),
            'dw': sdx, 'db': sdy, 'running_mean': (1 - f) * mean + f * mu,
            'running_var': (1 - f) * var + f * v,
            'scale': {'dw': (dyf * xhat).abs().sum(dims), 'db': dyf.abs().sum(dims)}}


@pytest.mark.cuda
@pytest.mark.parametrize('momentum', [0.1, None])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', CARD_SHAPES, ids=['x'.join(map(str, s)) for s in CARD_SHAPES])
def test_the_kernels_match_the_plain_version(card, shape, dtype, momentum):
    """y and the running statistics against the plain version; y, dx, dw,
    db and the running statistics against float64 from the same inputs
    (ATen's bf16 backward, the plain version's, rounds dw and db further
    than that: up to 78 times this tolerance on the card); the same bits on
    a second run."""
    g = torch.Generator(device=card).manual_seed(0)
    x = (2 * torch.randn(shape, generator=g, device=card) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=card).to(dtype)
    c = shape[1]
    params = [torch.rand(c, generator=g, device=card) + 0.5,
              0.1 * torch.randn(c, generator=g, device=card),
              0.1 * torch.randn(c, generator=g, device=card),
              torch.rand(c, generator=g, device=card) + 0.5]
    got = _run(bn.batch_norm_train, x, dy, params, momentum)
    again = _run(bn.batch_norm_train, x, dy, params, momentum)
    want = _run(bn.batch_norm_train_plain, x, dy, params, momentum)
    exact = _exact(x, dy, params, momentum)
    # one rounding to x's dtype, float32 sums in another order
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    for k in ('y', 'dx'):
        w = exact[k]
        assert torch.allclose(got[k].double(), w, rtol=rtol, atol=1e-5 * float(w.abs().max())), k
    w = want['y'].float()
    assert torch.allclose(got['y'].float(), w, rtol=2 * rtol, atol=1e-5 * float(w.abs().max()))
    for k in ('running_mean', 'running_var'):
        assert torch.allclose(got[k].double(), exact[k], rtol=1e-5, atol=1e-6), k
        assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6), k
    for k in ('dw', 'db'):
        assert ((got[k].double() - exact[k]).abs() <= 1e-5 * exact['scale'][k]).all(), k
    assert int(got['tracked']) == int(want['tracked']) == 1
    for k in got:
        assert torch.equal(got[k], again[k]), k


# every (C, H * W) of the train cells at batch 32 (C = 17 among them, and the
# split layers' largest, 67 MB in bf16), a row of 17 bf16 values, single
# values off 16-byte alignment, and n = 3
NHWC_SHAPES = ([(32, c, int(p ** 0.5), int(p ** 0.5), 0)
                for c, p in dict.fromkeys((c, p) for c, p, _ in FLAGSHIP + INTEGRAL)]
               + [(2, 6, 7, 9, 0), (2, 24, 16, 16, 1), (3, 5, 1, 1, 0)])


def _nhwc_inputs(card, shape, dtype, seed):
    b, c, h, w, offset = shape
    g = torch.Generator(device=card).manual_seed(seed)
    storage = torch.empty(b * c * h * w + offset, dtype=dtype, device=card)[offset:]
    x = storage.view(b, h, w, c).permute(0, 3, 1, 2)
    x.copy_(2 * torch.randn(b, c, h, w, generator=g, device=card) + 0.5)
    dy = _cl(torch.randn(b, c, h, w, generator=g, device=card).to(dtype))
    params = [torch.rand(c, generator=g, device=card) + 0.5,
              0.1 * torch.randn(c, generator=g, device=card),
              0.1 * torch.randn(c, generator=g, device=card),
              torch.rand(c, generator=g, device=card) + 0.5]
    return x, dy, params


@pytest.mark.cuda
@pytest.mark.parametrize('momentum', [0.1, None])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', NHWC_SHAPES, ids=['x'.join(map(str, s)) for s in NHWC_SHAPES])
def test_the_nhwc_kernels_match_the_plain_version(card, shape, dtype, momentum):
    """The channels-last pair, as test_the_kernels_match_the_plain_version
    holds the NCHW pair: y and dx channels-last, one host launch each way,
    the same bits on a second run."""
    x, dy, params = _nhwc_inputs(card, shape, dtype, seed=sum(shape))
    before = launch_counts('batch_norm_train_nhwc_fwd', 'batch_norm_train_nhwc_bwd')
    got = _run(bn.batch_norm_train_nhwc, x, dy, params, momentum)
    after = launch_counts('batch_norm_train_nhwc_fwd', 'batch_norm_train_nhwc_bwd')
    assert [after[k] - before[k] for k in after] == [1, 1]
    again = _run(bn.batch_norm_train_nhwc, x, dy, params, momentum)
    # the plain version from an aligned copy: cuDNN's channels-last batch
    # norm fails on x off 16-byte alignment
    want = _run(bn.batch_norm_train_plain, x.clone(), dy, params, momentum)
    exact = _exact(x, dy, params, momentum)
    assert bn.channels_last(got['y']) or got['y'].is_contiguous()
    assert got['y'].stride() == x.stride() and got['dx'].stride() == x.stride()
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    for k in ('y', 'dx'):
        w = exact[k]
        assert torch.allclose(got[k].double(), w, rtol=rtol, atol=1e-5 * float(w.abs().max())), k
    w = want['y'].float()
    assert torch.allclose(got['y'].float(), w, rtol=2 * rtol, atol=1e-5 * float(w.abs().max()))
    for k in ('running_mean', 'running_var'):
        assert torch.allclose(got[k].double(), exact[k], rtol=1e-5, atol=1e-6), k
        assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6), k
    for k in ('dw', 'db'):
        assert ((got[k].double() - exact[k]).abs() <= 1e-5 * exact['scale'][k]).all(), k
    assert int(got['tracked']) == int(want['tracked']) == 1
    for k in got:
        assert torch.equal(got[k], again[k]), k
