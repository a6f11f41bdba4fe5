"""The soaks (``margipose_tpu_torch.soak``) on the CPU, against the JAX
package's soak scripts.

* The port's ``schedule_values``, which the verifier holds the records to,
  equals the JAX package's at every update of a 150 x 8 schedule.
* A tiny full-schedule soak (1 stage, 64 px, the recipe's resnet18 stem and
  device augmentation with crop-ship, ``synthetic``, 6 epochs x 2 steps at
  batch 2) is SIGKILLed once epoch 3 is saved and resumed; the verifier
  passes, and the records and final train state equal an uninterrupted
  run's bit for bit (one thread a process).
* Three planted faults each fail the verifier on their own check.
* The run's final checkpoint, loaded by the JAX package
  (``margipose_tpu/train/torch_import.py``), gives the port's forward: this
  holds the trained weights to the JAX model where ``scripts/soak_verify.py``
  held them to the reference's executed model.
* ``soak/corpus.py`` writes ``scripts/make_soak_corpus.py``'s corpus array
  for array, and the fake-corpus recipe trains on it.

``-m slow`` adds a 12-epoch soak, long enough for the verifier's 1cycle
shape and convergence checks, killed once at epoch 6 and once halfway
through epoch 9's save.
"""

import concurrent.futures
import glob
import json
import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from margipose_tpu.train import schedules as jax_schedules
from margipose_tpu_torch.soak import corpus, faults, run, verify
from margipose_tpu_torch.train import checkpoint as ckpt
from margipose_tpu_torch.train.schedules import schedule_values
from test_torch_train_bin import _assert_states_equal

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ['batch_size=2', 'train_examples=4',
        "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}"]
RECORD_KEYS = ('epoch', 'lr', 'momentum', 'train_loss', 'train_pck', 'train_mpjpe')


@pytest.fixture(scope='module', autouse=True)
def one_thread_children():
    """The soak's processes inherit the environment: one thread each."""
    old = os.environ.get('OMP_NUM_THREADS')
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    if old is None:
        del os.environ['OMP_NUM_THREADS']
    else:
        os.environ['OMP_NUM_THREADS'] = old


@pytest.mark.parametrize('algorithm,lr', [('1cycle', 0.2), ('sgd_simple', 0.2),
                                          ('rmsprop', 2.5e-3)])
def test_schedule_values_match_jax_at_every_update(algorithm, lr):
    kwargs = dict(max_iters=150 * 8, milestones=[80, 140], gamma=0.1, steps_per_epoch=8)
    got = np.array([schedule_values(algorithm, lr, s, **kwargs) for s in range(150 * 8)])
    want = np.array([jax_schedules.schedule_values(algorithm, lr, s, **kwargs)
                     for s in range(150 * 8)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def _records(exp_dir):
    _, records, repeated = verify.read_records(exp_dir, verify.Checks(out=lambda line: None))
    return [{k: r[k] for k in RECORD_KEYS} for r in records], repeated


@pytest.fixture(scope='module')
def soaked(tmp_path_factory):
    """(the killed and resumed run's directory, the uninterrupted run's),
    the two runs side by side, one process each at a time."""
    out = str(tmp_path_factory.mktemp('soak'))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        killed = pool.submit(run.run_recipe, 'full-schedule', 'synthetic',
                             os.path.join(out, 'killed'), 'cpu', kill_at=3,
                             overrides=['epochs=6', *TINY], keep_killed=True, timeout=600)
        whole = pool.submit(run.run_recipe, 'full-schedule', 'synthetic',
                            os.path.join(out, 'whole'), 'cpu', overrides=['epochs=6', *TINY],
                            timeout=600)
        return killed.result(), whole.result()


def test_killed_and_resumed_soak_passes_and_equals_an_uninterrupted_run(soaked):
    killed, whole = soaked
    assert ckpt.load_meta(os.path.join(killed + '.killed', 'model-latest'))['epoch'] in (3, 4, 5)
    checks = verify.verify(killed, out=lambda line: None)
    assert checks.ok, checks.lines
    assert 'soak verification: ALL PASS' in checks.lines
    got, _ = _records(killed)
    want, repeated = _records(whole)
    assert got == want and not repeated
    _assert_states_equal(ckpt.load_payload(os.path.join(killed, 'model-latest')),
                         ckpt.load_payload(os.path.join(whole, 'model-latest')))


@pytest.mark.parametrize('kind', sorted(faults.CAUGHT_BY))
def test_planted_fault_fails_the_verifier(soaked, kind, tmp_path):
    killed, _ = soaked
    if kind == 'count':
        exp_dir = faults.count_off_by_one(killed + '.killed', str(tmp_path), 'full-schedule',
                                          'synthetic', 'cpu', ['epochs=6', *TINY], timeout=600)
    elif kind == 'batch_norm':
        exp_dir = faults.batch_norm_reset(killed, str(tmp_path))
    else:
        exp_dir = faults.missing_epoch(killed, str(tmp_path), 3)
    checks = verify.verify(exp_dir, out=lambda line: None)
    failed = [line for line in checks.lines if line.startswith('[FAIL]')]
    assert not checks.ok
    assert any(faults.CAUGHT_BY[kind] in line for line in failed), failed


def test_the_soaks_checkpoint_gives_the_jax_forward(soaked, tmp_path):
    """The trained state, exported as a reference ``.pth`` and imported by
    the JAX package, gives the port's coordinates within 1e-5. Its heatmaps
    are held to 1e-4: twelve updates at up to lr 0.2 saturate them (peaks of
    1.0, neighbours below 1e-20), where float32 reordering in the softmax's
    large logits moves a peak by 2.6e-05."""
    from margipose_tpu.train.torch_import import import_torch_model
    from margipose_tpu_torch.checkpoint import load_model, save_model

    killed, _ = soaked
    model, desc = load_model(os.path.join(killed, 'model-latest'), 'cpu')
    pth = str(tmp_path / 'soak.pth')
    save_model(pth, model, desc)
    jax_model, variables, jax_desc = import_torch_model(pth)
    assert jax_desc == desc
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    jax_xyz, jax_out = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, x)
    with torch.inference_mode():
        xyz, out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for plane in ('xy_heatmaps', 'zy_heatmaps', 'xz_heatmaps'):
        for got, want in zip(getattr(out, plane), getattr(jax_out, plane)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=plane)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jax_xyz), atol=1e-5)


def _files(base):
    return sorted(os.path.relpath(f, base) for f in glob.glob(os.path.join(base, '**', '*'),
                                                              recursive=True)
                  if os.path.isfile(f))


def _h5_arrays(name):
    arrays = {}
    with h5py.File(name, 'r') as f:
        f.visititems(lambda key, obj: arrays.__setitem__(key, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return arrays


def test_corpus_equals_the_jax_scripts_and_the_fake_recipe_trains(tmp_path, monkeypatch):
    jax_base, port_base = str(tmp_path / 'jax'), str(tmp_path / 'port')
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'scripts', 'make_soak_corpus.py')],
                          env={**os.environ, 'SOAK_DATA': jax_base, 'JAX_PLATFORMS': 'cpu'},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setenv('SOAK_DATA', port_base)
    assert corpus.make_soak_corpus() == port_base
    files = _files(port_base)
    assert files == _files(jax_base) and len(files) > 20
    for rel in files:
        a, b = os.path.join(port_base, rel), os.path.join(jax_base, rel)
        if h5py.is_hdf5(a):
            want = _h5_arrays(b)
            got = _h5_arrays(a)
            assert got.keys() == want.keys(), rel
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f'{rel}:{key}')
        else:
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                assert fa.read() == fb.read(), rel
    assert corpus.make_soak_corpus() == port_base  # idempotent: already there

    # set first, so that the teardown restores what use_fake_corpus sets
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', '')
    monkeypatch.setenv('MARGIPOSE_RESOURCES_DIR', os.path.join(ROOT, 'resources'))
    assert corpus.use_fake_corpus() == port_base
    assert os.environ['MARGIPOSE_BASE_DATA_DIR'] == port_base
    exp_dir = run.run_recipe('full-schedule', 'fake', str(tmp_path / 'out'), 'cpu',
                             overrides=['epochs=2', *TINY], timeout=600)
    checks = verify.verify(exp_dir, out=lambda line: None)
    assert checks.ok, checks.lines
    with open(os.path.join(exp_dir, 'config.json')) as f:
        assert json.load(f)['train_datasets'] == ['mpi3d-trainval', 'mpii-trainval']


def test_an_interrupted_corpus_generation_is_redone(tmp_path, monkeypatch):
    """A generation that stops after ``mpi3d/train`` (the MPII generator
    raises) leaves a corpus that is not taken for whole: the next call
    removes what it left and runs every generator again."""
    calls = []

    def fake(name):
        def generate(out_dir, **_):
            calls.append(name)
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f'{name}-{len(calls)}'), 'w'):
                pass
        return generate

    def interrupted(out_dir, **_):
        calls.append('mpii')
        raise OSError('stopped after mpi3d')

    base = str(tmp_path / 'corpus')
    monkeypatch.setattr(corpus, 'generate_fake_mpi3d', fake('mpi3d'))
    monkeypatch.setattr(corpus, 'generate_fake_mpii', interrupted)
    with pytest.raises(OSError, match='stopped after mpi3d'):
        corpus.make_soak_corpus(base)
    assert calls == ['mpi3d', 'mpi3d', 'mpii']
    assert os.path.isdir(os.path.join(base, 'mpi3d', 'train'))
    monkeypatch.setattr(corpus, 'generate_fake_mpii', fake('mpii'))
    assert corpus.make_soak_corpus(base) == base
    assert calls[3:] == ['mpi3d', 'mpi3d', 'mpii']
    assert _files(base) == ['mpi3d/train/mpi3d-4', 'mpi3d/val/mpi3d-5', 'mpii/mpii-6']
    assert corpus.make_soak_corpus(base) == base and len(calls) == 6  # whole now


@pytest.mark.slow
def test_twelve_epoch_soak_killed_twice_passes_every_check(tmp_path):
    exp_dir = run.run_recipe('full-schedule', 'synthetic', str(tmp_path), 'cpu', kill_at=6,
                             kill_in_save=9, overrides=['epochs=12', *TINY], timeout=1200)
    checks = verify.verify(exp_dir, out=lambda line: None)
    assert checks.ok, checks.lines
    assert not any(line.startswith('[SKIP] 1cycle') for line in checks.lines)
