"""The port's eval bin end to end against the JAX eval bin, on the CPU.

One small checkpoint (inceptionv4, 2 stages, 64 px) is exported from a JAX
MargiPose to the reference ``.pth`` format. The JAX bin
(``margipose_tpu.bin.eval_3d.main``) and the port's
(``margipose_tpu_torch.bin.eval_3d.main --device cpu``) both evaluate it on
``synthetic-4`` at batch 2, and with ``--multicrop``; their overall metrics
and mean loss must agree. So must a Chatterbox checkpoint's. ``--ship uint8`` and ``--precision bfloat16`` are
held to the port's own float32 run.
The port's drain window is also pinned as tests/test_eval_drain.py pins the
JAX one: a scheduling detail that never changes the predictions.
"""

import numpy as np
import pytest
import torch

import margipose_tpu.bin.eval_3d as jax_eval_3d
import margipose_tpu_torch.bin.eval_3d as eval_3d
from margipose_tpu.train.torch_import import export_state_dict
from test_torch_weights import jax_margipose, small_desc

METRICS = eval_3d.METRICS


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    desc = small_desc()
    _, variables = jax_margipose(desc, seed=4)
    path = str(tmp_path_factory.mktemp('ckpt') / 'small.pth')
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in export_state_dict(variables).items()}
    torch.save({'state_dict': state, 'model_desc': desc}, path)
    return path


def _run_jax_eval(args, monkeypatch):
    """The JAX eval bin on ``args``: (per-example table, stats). Both bins'
    crops come from their native host ops, the same library."""
    captured = {}
    run = jax_eval_3d.run_evaluation_3d

    def capture(*args, **kwargs):
        captured['df'], captured['stats'] = run(*args, **kwargs)
        return captured['df'], captured['stats']

    monkeypatch.setattr(jax_eval_3d, 'run_evaluation_3d', capture)
    jax_eval_3d.main(['eval'] + args, None)
    return captured['df'], captured['stats']


def _assert_tables_agree(got, expected):
    """Overall metrics: MPJPE within 0.1 mm, PCK and AUC within 1e-3."""
    for name in ('mpjpe', 'aligned_mpjpe'):
        assert abs(got[name] - expected[name]) <= 0.1, name
    for name in ('pck', 'auc', 'aligned_pck', 'aligned_auc'):
        assert abs(got[name] - expected[name]) <= 1e-3, name


ARGS = ['--dataset', 'synthetic-4', '--batch-size', '2']


@pytest.fixture(scope='module')
def port_float32(checkpoint):
    """The port's eval bin on the checkpoint with the defaults: float32, and
    float32 upload under --ship auto. (rows, stats, printed output)"""
    import contextlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rows, stats = eval_3d.main(['--model', checkpoint, *ARGS, '--device', 'cpu'])
    return rows, stats, printed.getvalue()


def test_eval_bin_matches_jax(checkpoint, port_float32, monkeypatch):
    df, jax_stats = _run_jax_eval(['--model', checkpoint, *ARGS], monkeypatch)
    rows, stats, printed = port_float32
    assert '### Overall' in printed and 'mean loss' in printed

    assert len(rows['mpjpe']) == len(df) == 4
    _assert_tables_agree(eval_3d.overall_metrics(rows), df[list(METRICS)].mean())
    np.testing.assert_allclose(stats['mean_loss'], jax_stats['mean_loss'], rtol=1e-4)
    assert stats['batches'] == 2


def test_chatterbox_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A Chatterbox checkpoint (full width, 256 px: the only size it runs
    at) through both bins on synthetic-2 at batch 2."""
    from test_torch_chatterbox import DESC, jax_chatterbox

    _, variables, _ = jax_chatterbox(seed=5)
    path = str(tmp_path / 'chatterbox.pth')
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in export_state_dict(variables).items()}
    torch.save({'state_dict': state, 'model_desc': DESC}, path)
    args = ['--model', path, '--dataset', 'synthetic-2', '--batch-size', '2']
    df, jax_stats = _run_jax_eval(args, monkeypatch)
    rows, stats = eval_3d.main(args + ['--device', 'cpu'])
    assert len(rows['mpjpe']) == len(df) == 2 and stats['batches'] == 1
    _assert_tables_agree(eval_3d.overall_metrics(rows), df[list(METRICS)].mean())
    np.testing.assert_allclose(stats['mean_loss'], jax_stats['mean_loss'], rtol=1e-4)


def test_multicrop_matches_jax(checkpoint, monkeypatch, capsys):
    """--multicrop: one crop-averaged prediction per example from its 10
    crops, unpadded, whatever --batch-size says."""
    args = ['--model', checkpoint, '--dataset', 'synthetic-2', '--multicrop']
    df, jax_stats = _run_jax_eval(args, monkeypatch)
    rows, stats = eval_3d.main(args + ['--batch-size', '4', '--device', 'cpu'])
    assert 'time per example (all crops)' in capsys.readouterr().out
    assert len(rows['mpjpe']) == len(df) == 2 and stats['batches'] == 2
    _assert_tables_agree(eval_3d.overall_metrics(rows), df[list(METRICS)].mean())
    np.testing.assert_allclose(stats['mean_loss'], jax_stats['mean_loss'], rtol=1e-4)


def test_uint8_shipping_matches_float32(checkpoint, port_float32, capsys):
    """--ship uint8 uploads the exact source pixels and renormalises them on
    the device: the tables agree with float32 upload's, which --ship auto
    picks under --precision float32."""
    rows_f32, stats_f32, printed = port_float32
    assert 'Input upload: float32' in printed
    rows_u8, stats_u8 = eval_3d.main(['--model', checkpoint, *ARGS, '--ship', 'uint8',
                                      '--device', 'cpu'])
    assert 'Input upload: uint8' in capsys.readouterr().out
    _assert_tables_agree(eval_3d.overall_metrics(rows_u8), eval_3d.overall_metrics(rows_f32))
    np.testing.assert_allclose(stats_u8['mean_loss'], stats_f32['mean_loss'], rtol=1e-4)


def test_bfloat16_eval_runs(checkpoint, port_float32, capsys):
    """--precision bfloat16 (autocast, uint8 upload under --ship auto): finite
    tables, and a loss within 5% of the float32 run's."""
    rows, stats = eval_3d.main(['--model', checkpoint, *ARGS, '--precision', 'bfloat16',
                                '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'Precision: bfloat16' in printed and 'Input upload: uint8' in printed
    assert len(rows['mpjpe']) == 4
    assert all(np.isfinite(rows[m]).all() for m in METRICS) and np.isfinite(stats['mean_loss'])
    np.testing.assert_allclose(stats['mean_loss'], port_float32[1]['mean_loss'], rtol=0.05)


class _FakeLoader:
    """Batches of variable n_real with a trailing short one."""

    dataset = None

    def __init__(self, batch_sizes, n_joints=17, seed=0):
        rnd = np.random.RandomState(seed)
        self.batches = [dict(
            input=rnd.randn(n, 2, 2, 3).astype(np.float32),
            target=rnd.uniform(-0.9, 0.9, (n, n_joints, 3)).astype(np.float32),
            valid_depth=np.ones((n,), np.int32),
            joint_mask=np.ones((n, n_joints), np.float32),
            original_skel=[rnd.randn(n_joints, 4) for _ in range(n)],
            camera_intrinsic=[None] * n,
            transform_opts=[{'batch': i, 'row': j} for j in range(n)],
        ) for i, n in enumerate(batch_sizes)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _fake_forward(images, target, mask, valid_depth):
    # a function of the inputs that tells padded rows apart; the loss is a
    # masked mean, as the real one is
    xyz = target + images.mean()
    return xyz, (images.sum((1, 2, 3))[:, None] * mask).sum() / mask.sum()


@pytest.fixture
def _stub_geometry(monkeypatch):
    def stub(original_skel, norm_pred, dataset, intrinsic, opts, known_depth=False):
        return np.asarray(original_skel)[..., :3], np.asarray(norm_pred)[..., :3]

    monkeypatch.setattr(eval_3d, 'prepare_for_3d_evaluation', stub)


def _collect(loader, batch_size, drain_window):
    return list(eval_3d.obtain_predictions(_fake_forward, loader, torch.device('cpu'),
                                           batch_size=batch_size, drain_window=drain_window))


@pytest.mark.parametrize('drain_window', [0, 1, 3, 16])
def test_drain_window_is_invisible(_stub_geometry, drain_window):
    ref = _collect(_FakeLoader([4, 4, 4, 2]), 4, drain_window=0)
    got = _collect(_FakeLoader([4, 4, 4, 2]), 4, drain_window=drain_window)
    assert len(ref) == len(got) == 14
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r['actual'], g['actual'])
        assert r['loss'] == g['loss'] and r['loss_n'] == g['loss_n']


def test_padded_tail_yields_only_real_rows(_stub_geometry):
    loader = _FakeLoader([4, 3])
    preds = _collect(loader, 4, drain_window=2)
    assert len(preds) == 7
    assert [i for i, p in enumerate(preds) if p['loss'] is not None] == [0, 4]
    assert [i for i, p in enumerate(preds) if p['inference_time'] is not None] == [0, 4]
    assert preds[4]['loss_n'] == 3
    # padding rows repeat the last example and are masked out of the loss
    tail = loader.batches[1]['input']
    assert preds[4]['loss'] == pytest.approx(float(tail.sum()) / 3, rel=1e-6)
    for row in range(3):
        expected = loader.batches[1]['target'][row] + np.concatenate(
            [tail, tail[-1:]]).mean(dtype=np.float32)
        np.testing.assert_allclose(preds[4 + row]['actual'], expected, rtol=1e-5, atol=1e-6)
