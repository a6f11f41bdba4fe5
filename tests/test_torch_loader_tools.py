"""The port's loader tools and DSNT helpers against the JAX package's.

- ``calc_dataloader_stats`` prints the JAX tool's lines, text for text, on
  ``synthetic-16``: under the primary flag spellings, the reference ones
  (``--examples-per-epoch``, ``--output``) with ``--epochs 2``, and with
  ``--epochs 0``, which makes no pass (the port's batches equal the JAX
  package's bit for bit).
- ``bench_loader --seconds 1 --workers 0`` prints host images/sec and no
  accelerator figure.
- ``coord_expectation``, ``coord_variance`` and ``kl_reg_losses`` equal the
  JAX package's within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.bin.calc_dataloader_stats as jax_stats
import margipose_tpu.ops as jax_ops
from margipose_tpu.ops.dsnt import coord_expectation as jax_coord_expectation
from margipose_tpu.ops.dsnt import coord_variance as jax_coord_variance
import margipose_tpu_torch.ops as ops
from margipose_tpu_torch.bin import bench_loader, calc_dataloader_stats

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


@pytest.mark.parametrize('flags', [
    ['--examples', '16', '--out-file', 'stats.png'],
    ['--examples-per-epoch', '16', '--output', 'stats.png', '--epochs', '2', '--batch-size', '8'],
    ['--examples', '16', '--out-file', 'stats.png', '--epochs', '0'],
], ids=['primary', 'reference-spellings-2-epochs', 'no-epochs'])
def test_dataloader_stats_print_the_jax_lines(flags, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ['calc_dataloader_stats', '--dataset', 'synthetic-16', *flags]
    jax_stats.main(argv)
    want = capsys.readouterr().out
    calc_dataloader_stats.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert 'target_x' in got and 'pixels' in got and 'wrote stats.png' in got
    assert ('n=0' in got) == ('--epochs' in flags and flags[flags.index('--epochs') + 1] == '0')


def test_bench_loader_prints_host_rates_only(capsys):
    results = bench_loader.main(['--seconds', '1', '--workers', '0', '--batch-size', '4'])
    out = capsys.readouterr().out
    assert list(results) == [0] and results[0] > 0
    assert 'workers=0:' in out and 'images/sec' in out
    for word in ('TPU', 'chip', 'BASELINE', '620'):
        assert word not in out


def _heatmaps(seed, shape=(2, 3, 7, 9)):
    rng = np.random.RandomState(seed)
    p = rng.rand(*shape).astype(np.float32) + 0.05
    return p / p.sum(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize('dim', [-1, -2, 2, 3])
def test_coord_moments_match_jax(dim):
    p = _heatmaps(dim + 10)
    for port_fn, jax_fn in ((ops.coord_expectation, jax_coord_expectation),
                            (ops.coord_variance, jax_coord_variance)):
        assert_allclose(port_fn(torch.from_numpy(p), dim).numpy(),
                        np.asarray(jax_fn(jnp.asarray(p), dim)), atol=1e-6, rtol=0)


@pytest.mark.parametrize('sigma', [1.0, 2.5])
def test_kl_reg_losses_match_jax(sigma):
    """Heatmaps as a model gives them near its targets: the target Gaussian
    mixed with noise, so the divergences are O(1), where float32 resolves
    1e-6."""
    mu = np.random.RandomState(4).uniform(-0.9, 0.9, (2, 3, 2)).astype(np.float32)
    gauss = ops.make_gauss(torch.from_numpy(mu), (7, 9), sigma).numpy()
    p = (0.7 * gauss + 0.3 * _heatmaps(3)).astype(np.float32)
    got = ops.kl_reg_losses(torch.from_numpy(p), torch.from_numpy(mu), sigma)
    assert_allclose(got.numpy(), np.asarray(jax_ops.kl_reg_losses(jnp.asarray(p), jnp.asarray(mu),
                                                                  sigma)), atol=1e-6, rtol=0)
    p_t, mu_t = torch.from_numpy(p).requires_grad_(), torch.from_numpy(mu).requires_grad_()
    ops.kl_reg_losses(p_t, mu_t, sigma).sum().backward()
    assert p_t.grad is not None and mu_t.grad is None  # the targets are constants
