"""The launch seam of the port's hand-written kernels (``ops/_build.py``).

``_build.KERNELS`` declares every C entry point of ``csrc/*.cu``: its
library, its ctypes arguments and the names its kernels run under in a
device trace. Calling an entry launches it on the tensors' card and current
stream, raises on a non-zero return without counting it, and otherwise
counts one host launch; ``launch_counts`` and ``zero_launch_counts`` read and
zero the counts. The protocol runs here against a stand-in for the C
function and the CUDA stream calls. The declarations are held to the
sources' ``extern "C"`` signatures and ``__global__`` kernels. Every wrapper
follows one device rule: a CPU tensor takes the plain version and launches
nothing.
"""

import contextlib
import ctypes
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from margipose_tpu_torch.ops import _build, launch_counts, zero_launch_counts
from margipose_tpu_torch.ops import batch_norm as bn
from margipose_tpu_torch.ops import softargmax3d as sa
from margipose_tpu_torch.ops.dsnt import flat_softmax
from margipose_tpu_torch.ops.dsnt_jsd import (
    dsnt_jsd_bwd,
    dsnt_jsd_bwd_plain,
    dsnt_jsd_fwd,
    dsnt_jsd_fwd_plain,
    dsnt_jsd_grouped,
    dsnt_jsd_plain,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_POINTS = {
    'dsnt_jsd': ('dsnt_jsd_fwd', 'dsnt_jsd_bwd', 'dsnt_jsd_log_check'),
    'softargmax3d': ('softargmax3d_fwd', 'softargmax3d_bwd'),
    'batch_norm': ('batch_norm_train_fwd', 'batch_norm_train_bwd', 'batch_norm_train_nhwc_fwd',
                   'batch_norm_train_nhwc_bwd'),
}
STREAM = 0x5EED  # the stand-in current stream's handle


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA device and stream calls replaced, so that an entry point
    launches here: ``give(symbol, err)`` makes ``symbol``'s C function a
    stand-in that records its arguments and returns ``err``; ``entered``
    lists the devices launches were made under."""
    entered, calls = [], []

    def device(d):
        entered.append(torch.device(d))
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, 'device', device)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=STREAM))

    def give(symbol, err):
        def fn(*args):
            calls.append(args)
            return err

        monkeypatch.setattr(_build.KERNELS[symbol], '_fn', fn)

    return types.SimpleNamespace(give=give, entered=entered, calls=calls)


def test_a_failed_launch_raises_naming_its_symbol_and_is_not_counted(stand_in):
    kernel = _build.KERNELS['softargmax3d_bwd']
    stand_in.give('softargmax3d_bwd', 700)
    before = launch_counts()
    with pytest.raises(RuntimeError, match='softargmax3d_bwd kernel launch failed: CUDA error 700'):
        kernel(torch.device('cuda', 1), 11, 22)
    assert launch_counts() == before
    assert stand_in.calls == [(11, 22, STREAM)]  # the arguments, then the current stream
    assert stand_in.entered == [torch.device('cuda', 1)]  # the tensors' card


def test_a_launch_counts_once_and_zeroing_resets_every_entry(stand_in):
    stand_in.give('batch_norm_train_fwd', 0)
    zero_launch_counts()
    _build.KERNELS['batch_norm_train_fwd'](torch.device('cuda', 0), 7)
    assert launch_counts() == {s: int(s == 'batch_norm_train_fwd') for s in _build.KERNELS}
    assert launch_counts('batch_norm_train_fwd', 'dsnt_jsd_fwd') == {
        'batch_norm_train_fwd': 1, 'dsnt_jsd_fwd': 0}
    for kernel in _build.KERNELS.values():
        kernel.launches = 3
    zero_launch_counts('dsnt_jsd_bwd')
    assert launch_counts()['dsnt_jsd_bwd'] == 0 and launch_counts()['dsnt_jsd_fwd'] == 3
    zero_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_the_registry_holds_every_entry_point_of_every_kernel_source():
    assert {k.library for k in _build.KERNELS.values()} == set(_build.kernel_sources())
    assert {s: k.library for s, k in _build.KERNELS.items()} == {
        s: library for library, symbols in ENTRY_POINTS.items() for s in symbols}
    assert _build.takes_kernel(torch.device('cuda', 1))
    assert not _build.takes_kernel(torch.device('cpu'))
    assert not _build.takes_kernel(torch.device('meta'))
    # whichever wrappers a process imported: here none but the loss head's
    code = ('import sys\n'
            'from margipose_tpu_torch.ops import _build\n'
            'print(sorted(_build.KERNELS), sorted(m for m in sys.modules if m in (\n'
            '    "margipose_tpu_torch.ops.batch_norm", "margipose_tpu_torch.ops.softargmax3d")))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env={**os.environ, 'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f'{sorted(_build.KERNELS)} []'


def _c_type(param):
    """The ctypes type of one C parameter declaration."""
    if '*' in param:
        return ctypes.POINTER(ctypes.c_uint64) if 'uint64_t' in param else ctypes.c_void_p
    return {'int': ctypes.c_int, 'float': ctypes.c_float}[param.split()[0]]


@pytest.mark.parametrize('symbol', sorted(_build.KERNELS))
def test_each_declaration_matches_its_source(symbol):
    """The arguments are the C signature's, the stream last, and each traced
    name is a ``__global__`` kernel of the library."""
    kernel = _build.KERNELS[symbol]
    with open(os.path.join(_build.CSRC, f'{kernel.library}.cu')) as f:
        source = f.read()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', source).group(1)
    want = [_c_type(p.strip()) for p in params.split(',')]
    assert [*kernel.argtypes, ctypes.c_void_p] == want
    assert params.split(',')[-1].split() == ['void*', 'stream']
    heads = [re.sub(r'__\w+__\([^)]*\)', '', h) for h in re.findall(r'__global__([^{]*)\{', source)]
    kernels = {re.search(r'(\w+)\(', h).group(1) for h in heads}
    assert kernel.traced and set(kernel.traced) <= kernels


def _dsnt_jsd_on_cpu():
    g = torch.Generator().manual_seed(11)
    hms = [flat_softmax(2 * torch.randn(2, 5, 8, 12, generator=g)) for _ in range(3)]
    mus = [1.6 * torch.rand(2, 5, 2, generator=g) - 0.8 for _ in range(3)]
    rows = dsnt_jsd_fwd(hms, mus, 1.5)
    assert rows.shape == (3, 10, 4) and torch.equal(rows, dsnt_jsd_fwd_plain(hms, mus, 1.5))
    for row, hm, mu in zip(rows, hms, mus):
        coords, jsd = dsnt_jsd_plain(hm, mu, 1.5)
        assert torch.equal(row[:, :2], coords.reshape(-1, 2))
        assert torch.equal(row[:, 2], jsd.reshape(-1))
        assert torch.equal(row[:, 3], torch.zeros(10))
    grad = torch.randn(3, 10, 4, generator=g)
    assert torch.equal(dsnt_jsd_bwd(hms, mus, grad, 1.5), dsnt_jsd_bwd_plain(hms, mus, grad, 1.5))
    leaves = [hm.clone().requires_grad_() for hm in hms]
    for (coords, jsd), (want_coords, want_jsd) in zip(
            dsnt_jsd_grouped(leaves, mus, 1.5), [dsnt_jsd_plain(hm, mu, 1.5)
                                                 for hm, mu in zip(hms, mus)]):
        assert torch.equal(coords, want_coords) and torch.equal(jsd, want_jsd)
        (coords.sum() + jsd.sum()).backward()


def _softargmax3d_on_cpu():
    g = torch.Generator().manual_seed(12)
    logits = torch.randn(2, 3 * 4, 5, 8, generator=g)
    xyz, stats = sa.softargmax3d_fwd(logits, 4)
    want_xyz, want_stats = sa.softargmax3d_fwd_plain(logits, 4)
    assert torch.equal(xyz, want_xyz) and torch.equal(stats, want_stats)
    grad = torch.randn(2, 3, 3, generator=g)
    assert torch.equal(sa.softargmax3d_bwd(logits, 4, xyz, stats, grad),
                       sa.softargmax3d_bwd_plain(logits, 4, xyz, stats, grad))
    leaf = logits.clone().requires_grad_()
    out = sa.softargmax3d(leaf, 4)
    assert torch.equal(out, sa.softargmax3d_plain(logits, 4))
    out.backward(grad)


def _batch_norm_on_cpu():
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 3, 4, 4, generator=g)
    weight, bias = torch.rand(3, generator=g), torch.randn(3, generator=g)

    def stats():
        return torch.zeros(3), torch.ones(3), torch.zeros((), dtype=torch.long)

    leaf = x.clone().requires_grad_()
    y = bn.batch_norm_train(leaf, weight, bias, *stats(), 0.1, 1e-5)
    assert torch.equal(y, bn.batch_norm_train_plain(x, weight, bias, *stats(), 0.1, 1e-5))
    y.sum().backward()
    # the kernels' own entry refuses a CPU tensor: only batch_norm_train routes
    with pytest.raises(ValueError, match='CUDA device'):
        bn.batch_norm_train_fwd(torch.zeros(2, 3, 4, 4), None, None, torch.zeros(3),
                                torch.ones(3), torch.zeros((), dtype=torch.long), 0.1, 1e-5)
    # channels-last: the same plain version
    cl = x.contiguous(memory_format=torch.channels_last)
    leaf = cl.clone().requires_grad_()
    y = bn.batch_norm_train_nhwc(leaf, weight, bias, *stats(), 0.1, 1e-5)
    assert torch.equal(y, bn.batch_norm_train_plain(cl, weight, bias, *stats(), 0.1, 1e-5))
    y.sum().backward()
    with pytest.raises(ValueError, match='CUDA device'):
        bn.batch_norm_train_nhwc_fwd(cl, None, None, torch.zeros(3), torch.ones(3),
                                     torch.zeros((), dtype=torch.long), 0.1, 1e-5)


CPU_PATHS = {'dsnt_jsd': _dsnt_jsd_on_cpu, 'softargmax3d': _softargmax3d_on_cpu,
             'batch_norm': _batch_norm_on_cpu}


@pytest.mark.parametrize('library', sorted({k.library for k in _build.KERNELS.values()}))
def test_a_cpu_tensor_takes_the_plain_version_and_counts_no_launch(library):
    symbols = [s for s, k in _build.KERNELS.items() if k.library == library]
    before = launch_counts(*symbols)
    CPU_PATHS[library]()
    assert launch_counts(*symbols) == before
