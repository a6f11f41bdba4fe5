"""The port's real datasets against the JAX package's, on the CPU.

One small fake corpus (``margipose_tpu/data/fake_mpi3d.py`` and
``fakes.py``: MPI-INF-3DHP train/val/test, Human3.6M, MPII) serves every
test of the file. Both packages read it with the same data specs (64 px,
ImageNet normalisation, the 17-joint canonical skeleton) and seeds.
Compositing, the warp and the colour jitter run through the same native
host-ops library on both sides, so samples and batches must be equal bit
for bit: ``input``, ``target``, ``joint_mask``, ``valid_depth``,
``camera_intrinsic`` and the numbers of ``transform_opts``, through each
package's ``DataLoader`` at epochs 0 and 1 and 0 or 2 worker threads.
``evaluate_3d_batch`` metrics agree within 1e-6 mm (the same float64 numpy
on both sides).
"""

import filecmp
import os
import urllib.request

import numpy as np
import pytest
import torch

import margipose_tpu.data.get_dataset as jax_get_dataset
import margipose_tpu.data.loader as jax_loader
import margipose_tpu.train.helpers as jax_helpers
import margipose_tpu_torch.data.get_dataset as get_dataset
import margipose_tpu_torch.data.loader as loader
import margipose_tpu_torch.train.helpers as helpers
from margipose_tpu.data import fake_mpi3d as jax_fake_mpi3d
from margipose_tpu.data import fakes as jax_fakes
from margipose_tpu.data.mixed import MixedPoseDataset as JaxMixed
from margipose_tpu.data.mixed import RoundRobinSampler as JaxRoundRobin
from margipose_tpu.models import data_specs_for_desc as jax_specs_for_desc
from margipose_tpu_torch.data import fake_mpi3d, fakes
from margipose_tpu_torch.data.mixed import MixedPoseDataset, RoundRobinSampler
from margipose_tpu_torch.data.mpii import install_mpii_dataset
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.models import data_specs_for_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESC = {'settings': {'input_size': 64}}
SEED = 5
NAMES = ['mpi3d-train', 'mpi3d-val', 'mpi3d-test', 'mpi3d-test-uncorrected',
         'mpi3d-trainval', 'h36m-trainval', 'h36m-test', 'mpii-train', 'mpii-val',
         'mpii-trainval', 'mpii-test', 'synthetic-8@1']


def make_corpus(base, fake_mpi3d_module, fakes_module):
    """The file's corpus under ``base``, written by one package's fakes.
    S1/Seq1 and S2/Seq2 are bg/ub/lb-augmentable (mpi3d_sequence_info.json),
    so every compositing branch is reachable."""
    gen = fake_mpi3d_module.generate_fake_mpi3d
    gen(os.path.join(base, 'mpi3d', 'train'), seqs=((2, 2),), camera_ids=(0,), n_frames=3)
    gen(os.path.join(base, 'mpi3d', 'val'), seqs=((1, 1),), camera_ids=(0,), n_frames=2,
        seed=1)
    for subset in ('test', 'test-uncorrected'):
        gen(os.path.join(base, 'mpi3d', subset), seqs=((1, 1), (2, 1)), camera_ids=(0,),
            n_frames=2, with_activities=True, seed=2)
    fakes_module.generate_fake_h36m(os.path.join(base, 'h36m'), subjects=(1, 9),
                                    camera_ids=(1,), n_frames=2)
    fakes_module.generate_fake_mpii(os.path.join(base, 'mpii'), n_train=4, n_val=2)
    return base


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp('datasets')), jax_fake_mpi3d, jax_fakes)


@pytest.fixture(autouse=True)
def _environment(corpus, monkeypatch):
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', corpus)
    monkeypatch.setenv('MARGIPOSE_RESOURCES_DIR', os.path.join(ROOT, 'resources'))


def _specs():
    return jax_specs_for_desc(DESC), data_specs_for_desc(DESC)


def numbers(value):
    """The numbers of a sample field, flattened in a fixed order: arrays,
    scalars, cameras' matrices, and dicts and lists recursively."""
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in numbers(value[k])]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in numbers(v)]
    if hasattr(value, 'matrix'):  # either package's CameraIntrinsics
        return numbers(value.matrix)
    if value is None:
        return []
    return list(np.asarray(value, np.float64).reshape(-1))


FIELDS = ('input', 'target', 'joint_mask', 'valid_depth', 'camera_intrinsic',
          'transform_opts')


def assert_samples_equal(got, want):
    for key in FIELDS:
        if key in want:
            assert np.array_equal(numbers(got[key]), numbers(want[key])), key
            if isinstance(want[key], np.ndarray):
                assert got[key].dtype == want[key].dtype, key


def build(package, kind, use_aug):
    """``kind``'s dataset from ``package`` ('jax' or 'port')."""
    base = os.environ['MARGIPOSE_BASE_DATA_DIR']
    specs = _specs()[package == 'port']
    if package == 'jax':
        from margipose_tpu.data.h36m import H36MDataset
        from margipose_tpu.data.mpi_inf_3dhp import MpiInf3dDataset
        from margipose_tpu.data.mpii import MpiiDataset
        mixed = JaxMixed
    else:
        from margipose_tpu_torch.data.h36m import H36MDataset
        from margipose_tpu_torch.data.mpi_inf_3dhp import MpiInf3dDataset
        from margipose_tpu_torch.data.mpii import MpiiDataset
        mixed = MixedPoseDataset

    def mpi3d(seed=SEED):
        return MpiInf3dDataset(os.path.join(base, 'mpi3d', 'train'), data_specs=specs,
                               use_aug=use_aug, seed=seed)

    def mpii(seed=SEED):
        return MpiiDataset(os.path.join(base, 'mpii'), data_specs=specs, subset='trainval',
                           use_aug=use_aug, seed=seed)

    if kind == 'mpi3d':
        return mpi3d()
    if kind == 'h36m':
        return H36MDataset(os.path.join(base, 'h36m'), data_specs=specs, subset='trainval',
                           use_aug=use_aug, seed=SEED)
    if kind == 'mpii':
        return mpii()
    return mixed([mpi3d(), mpii(SEED + 7919)])


def epochs_of_batches(package, dataset, num_workers, epochs=(0, 1)):
    module = jax_loader if package == 'jax' else loader
    dl = module.DataLoader(dataset, sampler=dataset.sampler(examples_per_epoch=4, seed=3),
                           batch_size=2, drop_last=True, num_workers=num_workers)
    out = []
    for epoch in epochs:
        dl.set_epoch(epoch)
        out.extend(dl)
    return out


@pytest.mark.parametrize('num_workers', [0, 2])
@pytest.mark.parametrize('use_aug', [False, True], ids=['plain', 'augmented'])
@pytest.mark.parametrize('kind', ['mpi3d', 'h36m', 'mpii', 'mixed'])
def test_batches_equal_jax_bit_for_bit(kind, use_aug, num_workers):
    want = epochs_of_batches('jax', build('jax', kind, use_aug), num_workers)
    got = epochs_of_batches('port', build('port', kind, use_aug), num_workers)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert_samples_equal(g, w)
    if kind == 'mixed':
        assert {int(v) for b in got for v in b['valid_depth']} == {0, 1}
    if use_aug:  # epoch 1 draws afresh
        assert not all(np.array_equal(a['input'], b['input']) for a, b in zip(got[:2], got[2:]))


@pytest.mark.parametrize('kind', ['mpi3d', 'h36m'])
def test_multicrop_samples_equal_jax(kind):
    datasets = [build(package, kind, False) for package in ('jax', 'port')]
    for ds in datasets:
        ds.multicrop = True
    want, got = (ds[1] for ds in datasets)
    assert got['input'].shape == (10, 64, 64, 3)
    assert_samples_equal(got, want)


def test_train_loader_batches_equal_jax_with_per_source_seeds():
    """The mpi3d preset's loader (mpi3d-trainval + mpii-trainval, augmented):
    source i gets the seed seed + 7919 i and mpi3d-trainval's val half seed
    + 1, as in JAX, so the batches are JAX's bit for bit. Another loader
    seed draws other augmentations."""
    names = ['mpi3d-trainval', 'mpii-trainval']
    jax_specs, specs = _specs()

    def batches(module, data_specs, seed):
        dl = module.create_train_dataloader(names, data_specs, 2, 6, use_aug=True,
                                            num_workers=0, seed=seed)
        out = []
        for epoch in (0, 1):
            dl.set_epoch(epoch)
            out.extend(dl)
        return dl, out

    dl, got = batches(helpers, specs, 12345)
    _, want = batches(jax_helpers, jax_specs, 12345)
    mpi3d, mpii = dl.dataset.datasets
    assert [d._aug_seed for d in mpi3d.datasets] == [12345, 12346]
    assert mpii._aug_seed == 12345 + 7919
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert_samples_equal(g, w)
    _, other = batches(helpers, specs, 777)
    assert not all(np.array_equal(a['input'], b['input']) for a, b in zip(got, other))


@pytest.mark.parametrize('name', NAMES)
def test_get_dataset_resolves_every_name_as_jax_does(name):
    jax_specs, specs = _specs()
    want = jax_get_dataset.get_dataset(name, jax_specs, use_aug=True, seed=11)
    got = get_dataset.get_dataset(name, specs, use_aug=True, seed=11)

    def describe(ds):
        parts = getattr(ds, 'datasets', [ds])
        return (type(ds).__name__, len(ds), [
            (type(d).__name__, len(d), getattr(d, 'use_aug', None), getattr(d, 'subset', None),
             getattr(d, '_aug_seed', None)) for d in parts])

    assert describe(got) == describe(want)
    assert len(got) > 0 or name == 'mpii-test'  # the fake MPII has no test.h5


def test_mpii_trainval_includes_val():
    """Regression (as tests/test_h36m_mpii_datasets.py): 'mpii-trainval' is
    the trainval subset, not 'train' by a prefix match."""
    specs = _specs()[1]
    ds = get_dataset.get_dataset('mpii-trainval', specs)
    assert ds.subset == 'trainval' and len(ds) == 6
    assert len(get_dataset.get_dataset('mpii-train', specs)) == 4


@pytest.mark.parametrize('name', ['mpi3d-test', 'h36m-test'])
def test_missing_data_names_both_remedies(tmp_path, monkeypatch, name):
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', str(tmp_path / 'absent'))
    jax_specs, specs = _specs()
    with pytest.raises(NotADirectoryError) as want:
        jax_get_dataset.get_dataset(name, jax_specs)
    with pytest.raises(NotADirectoryError) as got:
        get_dataset.get_dataset(name, specs)
    assert str(got.value) == str(want.value)
    assert 'MARGIPOSE_BASE_DATA_DIR' in str(got.value) and 'synthetic' in str(got.value)
    assert get_dataset.base_data_dir() == str(tmp_path / 'absent')
    with pytest.raises(ValueError, match='unrecognised dataset'):
        get_dataset.get_dataset('mpi3d-nope', specs)


def test_round_robin_order_equals_jax():
    lists = [range(0, 4), range(4, 10), range(10, 13)]
    for seed in (None, 7):
        got, want = RoundRobinSampler(lists, 14, seed=seed), JaxRoundRobin(lists, 14, seed=seed)
        if seed is None:  # unseeded: the same alternation of sources
            assert [i < 4 for i in got] == [i < 4 for i in want]
            continue
        for epoch in (0, 1, 5):
            assert list(got.iter_epoch(epoch)) == list(want.iter_epoch(epoch))
        assert list(got.iter_epoch(0)) != list(got.iter_epoch(1))


@pytest.mark.parametrize('name', ['mpi3d-test', 'h36m-test', 'mpi3d-trainval'])
def test_evaluate_3d_batch_matches_jax(name):
    jax_specs, specs = _specs()
    datasets = (jax_get_dataset.get_dataset(name, jax_specs),
                get_dataset.get_dataset(name, specs))
    batches = [next(iter(module.make_dataloader(ds, batch_size=2)))
               for module, ds in zip((jax_loader, loader), datasets)]
    rng = np.random.RandomState(3)
    target = np.asarray(batches[0]['target'], np.float64)
    preds = target.copy()
    preds[..., :3] += rng.uniform(-0.1, 0.1, preds[..., :3].shape)
    want, got = (ds.evaluate_3d_batch(batch, preds) for ds, batch in zip(datasets, batches))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            tol = 1e-6 if 'mpjpe' in key else 1e-9
            assert abs(g[key] - w[key]) <= tol, key


def test_fake_corpora_equal_jax_file_for_file(corpus, tmp_path):
    """The port's fakes write the JAX fakes' files, byte for byte."""
    mine = make_corpus(str(tmp_path / 'port'), fake_mpi3d, fakes)
    compared = 0
    for dirpath, _, files in os.walk(corpus):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), corpus)
            if f.endswith(('.jpg', '.png', '.calibration')):
                assert filecmp.cmp(os.path.join(corpus, rel), os.path.join(mine, rel),
                                   shallow=False), rel
                compared += 1
            else:
                assert os.path.isfile(os.path.join(mine, rel)), rel
    assert compared > 40


def test_install_mpii_dataset_is_idempotent_without_network(tmp_path, monkeypatch):
    """A layout already in place downloads nothing (as JAX's test); any
    download attempt fails the test instead of reaching the network."""
    def no_network(*args, **kwargs):
        raise AssertionError(f'download attempted: {args}')

    monkeypatch.setattr(urllib.request, 'urlretrieve', no_network)
    d = fakes.generate_fake_mpii(str(tmp_path / 'mpii'), n_train=2, n_val=1)
    open(os.path.join(d, 'annot', 'test.h5'), 'wb').close()
    assert install_mpii_dataset(d, skip_images=True) == []
    assert install_mpii_dataset(d) == []  # images/ present too


def test_camera_calibration_parses_as_jax():
    from margipose_tpu.data.mpi_inf_3dhp import parse_camera_calibration as jax_parse
    from margipose_tpu_torch.data.mpi_inf_3dhp import parse_camera_calibration

    path = os.path.join(os.environ['MARGIPOSE_BASE_DATA_DIR'], 'mpi3d', 'train', 'S2', 'Seq2',
                        'camera.calibration')
    with open(path) as f:
        got = parse_camera_calibration(f)
    with open(path) as f:
        want = jax_parse(f)
    assert sorted(got) == sorted(want)
    for cid in want:
        assert isinstance(got[cid]['intrinsics'], CameraIntrinsics)
        assert numbers(got[cid]) == numbers(want[cid])
