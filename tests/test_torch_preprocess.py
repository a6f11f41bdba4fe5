"""The port's MPI-INF-3DHP preprocessor against the JAX package's, on the CPU.

The pure-numpy numerics on tests/test_preprocess.py's inputs must give the
JAX functions' results exactly. The two paths that need no ``ffmpeg`` run
end to end in both packages on the same raw fakes: the test set through the
preprocess CLI, and a train sequence with its masks through the resume path
(frames already extracted). Both packages must write the same files: equal
HDF5 datasets, calibration text and images. Frame extraction itself runs
``ffmpeg`` and is not exercised here, as in tests/test_preprocess.py.
"""

import os
import shutil

import h5py
import numpy as np
import torch
import PIL.Image

import margipose_tpu.data.mpi3d_preprocess as jax_pre
import margipose_tpu_torch.data.mpi3d_preprocess as pre
from margipose_tpu.bin.preprocess_mpi3d import main as jax_preprocess_main
from margipose_tpu.data.fake_mpi3d import (
    generate_fake_raw_mpi3d_test,
    generate_fake_raw_mpi3d_train,
)
from margipose_tpu_torch.bin.preprocess_mpi3d import main as preprocess_main
from margipose_tpu_torch.data.mpi_inf_3dhp import MpiInf3dDataset, MpiInf3dhpSkeletonDesc
from margipose_tpu_torch.models import data_specs_for_desc
from test_preprocess import _fake_annot

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


def _h5_items(path):
    items = {}
    with h5py.File(path, 'r') as f:
        f.visititems(lambda name, obj: items.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return items


def assert_trees_equal(got_dir, want_dir):
    """Every file under ``want_dir`` exists under ``got_dir`` with the same
    content: HDF5 datasets equal, other files equal byte for byte."""
    n = 0
    for dirpath, _, files in os.walk(want_dir):
        for f in files:
            want = os.path.join(dirpath, f)
            got = os.path.join(got_dir, os.path.relpath(want, want_dir))
            if f.endswith('.h5'):
                a, b = _h5_items(got), _h5_items(want)
                assert sorted(a) == sorted(b), got
                for key in b:
                    assert np.array_equal(a[key], b[key]), (got, key)
            else:
                with open(got, 'rb') as g, open(want, 'rb') as w:
                    assert g.read() == w.read(), got
            n += 1
    assert n > 0


def test_numerics_equal_jax():
    raw = _fake_annot(n_frames=6)
    got, want = pre.Annotations(raw), jax_pre.Annotations(raw)
    for name in ('annot2', 'annot3', 'univ_annot3'):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert pre.calculate_univ_scale_factor(got.annot3[0], got.univ_annot3[0],
                                           MpiInf3dhpSkeletonDesc) == \
        jax_pre.calculate_univ_scale_factor(want.annot3[0], want.univ_annot3[0],
                                            MpiInf3dhpSkeletonDesc)
    # frames 1-2 nearly still after frame 0, frame 3 a jump (test_preprocess.py)
    for t, step in ((1, 1.0), (2, 5.0), (3, 300.0)):
        got.univ_annot3[0, t] = want.univ_annot3[0, t] = want.univ_annot3[0, 0] + step
    assert pre.interesting_frame_indices(got, 0, 6) == jax_pre.interesting_frame_indices(want, 0, 6)
    rng = np.random.RandomState(1)
    x3d = rng.uniform(-800, 800, (50, 28, 3)) + [0, 0, 4000]
    annot2 = np.stack([x3d[..., 0] / x3d[..., 2] * 1500 + 1024,
                       x3d[..., 1] / x3d[..., 2] * 1495 + 768], axis=-1)
    assert np.array_equal(pre.infer_test_intrinsics(annot2, x3d),
                          jax_pre.infer_test_intrinsics(annot2, x3d))


def test_is_image_ok_as_jax(tmp_path):
    for name, value in (('ok.jpg', 128), ('flash.png', 255)):
        path = str(tmp_path / name)
        PIL.Image.fromarray(np.full((32, 32, 3), value, np.uint8)).save(path)
        assert pre.is_image_ok(path) == jax_pre.is_image_ok(path) == (value == 128)


def test_test_set_cli_writes_what_jax_writes(tmp_path):
    raw = str(tmp_path / 'raw')
    generate_fake_raw_mpi3d_test(raw, n_frames=3, img_size=512)
    preprocess_main(['preprocess', '-t', raw, '-o', str(tmp_path / 'port')])
    jax_preprocess_main(['preprocess', '-t', raw, '-o', str(tmp_path / 'jax')])
    assert_trees_equal(str(tmp_path / 'port'), str(tmp_path / 'jax'))

    ds = MpiInf3dDataset(str(tmp_path / 'port' / 'test'),
                         data_specs=data_specs_for_desc({'settings': {'input_size': 64}}))
    assert len(ds) == 6 * 2 and ds.frame_refs[0].activity_id == 1
    assert ds[0]['input'].shape == (64, 64, 3)


def test_train_sequence_and_masks_write_what_jax_writes(tmp_path):
    raw_seq, _ = generate_fake_raw_mpi3d_train(
        str(tmp_path / 'raw'), str(tmp_path / 'jax'), subj_id=2, seq_id=2, n_frames=3)
    shutil.copytree(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    for module, out in ((jax_pre, 'jax'), (pre, 'port')):
        seq = os.path.join(str(tmp_path / out), 'S2', 'Seq2')
        module.process_sequence(raw_seq, seq, n_frames=3, blacklist=[])
        module.preprocess_masks(str(tmp_path / out), 2, 2)
    assert_trees_equal(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert os.path.isfile(os.path.join(str(tmp_path / 'port'), 'S2', 'Seq2', 'foreground_mask',
                                       'video_0', 'img_000001.png'))
