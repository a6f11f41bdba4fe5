"""MPI-INF-3DHP raw -> processed layout preprocessing.

(reference: src/margipose/data/mpi_inf_3dhp/preprocess.py:21-336). Raw videos
are decoded via an ffmpeg subprocess; "interesting" frames are selected by
pose movement; universal scale factors and test-set camera intrinsics are
computed; compositing-augmentation masks are generated.

The port's copy of ``margipose_tpu/data/mpi3d_preprocess.py``.
"""

from __future__ import annotations

import os
from os import path
from shutil import copy, move, which
from subprocess import call
from tempfile import TemporaryDirectory

import numpy as np
import PIL.Image
import PIL.ImageChops
import PIL.ImageDraw
import PIL.ImageFilter
import PIL.ImageOps

from margipose_tpu_torch.data.mpi_inf_3dhp import Constants, MpiInf3dhpSkeletonDesc
from margipose_tpu_torch.geometry.skeleton import (
    CanonicalSkeletonDesc,
    absolute_to_root_relative,
    torch_median,
)


def _progress(iterator, name):
    try:
        from tqdm import tqdm

        return tqdm(iterator, desc=f'{name:10s}', ascii=True, leave=False)
    except ImportError:
        return iterator


class Annotations:
    """Reshaped views of a loaded annot.mat
    (reference: src/margipose/data/mpi_inf_3dhp/common.py:73-85)."""

    def __init__(self, annot):
        self.annot = annot
        assert np.array_equal(
            annot['cameras'].flatten(), np.arange(Constants['n_cameras']))
        assert np.array_equal(
            annot['frames'].flatten(), np.arange(annot['frames'].shape[0]))
        self.annot3 = self._reshape(annot['annot3'], 3)
        self.univ_annot3 = self._reshape(annot['univ_annot3'], 3)
        self.annot2 = self._reshape(annot['annot2'], 2)

    @staticmethod
    def _reshape(arr, ndims):
        arr = np.stack(arr.flatten())
        return arr.reshape((arr.shape[0], arr.shape[1], 28, ndims))


def is_image_ok(image_file) -> bool:
    """Reject flash-washed frames: >1/3 of pixels near-white
    (reference: preprocess.py:25-36)."""
    img = PIL.Image.open(image_file)
    grey = np.array(img).mean(axis=-1)
    return (grey > 250).sum() <= (img.height * img.width) / 3.0


def process_camera_video(in_dir, out_dir, camera_id, frame_indices):
    """ffmpeg-extract 768x768 frames for image/chair-mask/fg-mask videos
    (reference: preprocess.py:39-76)."""
    subdirs = [('imageSequence', 'jpg'), ('ChairMasks', 'png'), ('FGmasks', 'jpg')]
    for subdir, ext in _progress(subdirs, 'Videos'):
        frames_dir = path.join(out_dir, subdir, 'video_%d' % camera_id)
        os.makedirs(frames_dir, exist_ok=True)

        existing = set(os.listdir(frames_dir))
        wanted = ['img_%06d.%s' % (i + 1, ext) for i in frame_indices]
        if all(f in existing for f in wanted):
            continue

        video_file = path.join(in_dir, subdir, 'video_%d.avi' % camera_id)
        if which('ffmpeg') is None:
            raise RuntimeError(
                'ffmpeg not found on PATH — it is required to extract video '
                'frames during MPI-INF-3DHP preprocessing (see README)')
        with TemporaryDirectory(prefix='tmp_', dir=out_dir) as tmp_dir:
            retcode = call([
                'ffmpeg', '-nostats', '-loglevel', '16',
                '-i', video_file,
                '-vf', 'scale=768:768',
                '-qscale:v', '3',
                path.join(tmp_dir, f'img_%06d.{ext}'),
            ])
            if retcode != 0:
                raise RuntimeError(f'failed to extract frames from "{video_file}"')
            for filename in wanted:
                move(path.join(tmp_dir, filename), path.join(frames_dir, filename))


def interesting_frame_indices(annot: Annotations, camera_id, n_frames):
    """Frames whose pose moved >=200mm since the last kept frame and whose
    2D joints are in-bounds (reference: preprocess.py:79-102)."""
    univ_annot3 = annot.univ_annot3[camera_id]
    annot2 = annot.annot2[camera_id]
    frame_indices = []
    prev = None
    threshold = 200.0 ** 2
    for i in range(n_frames):
        joints3d = univ_annot3[i]
        if prev is not None:
            max_move = ((joints3d - prev) ** 2).sum(-1).max()
            if max_move < threshold:
                continue
        if annot2[i].min() >= 0 and annot2[i].max() < 2048:
            prev = joints3d
            frame_indices.append(i)
    return frame_indices


def calculate_univ_scale_factor(annot3, univ_annot3, skel_desc):
    """Median ratio between metric and universal root-relative skeletons,
    excluding joints known-bad in the revised TS6 release
    (reference: preprocess.py:105-125)."""
    rel_annot3 = absolute_to_root_relative(np.asarray(annot3), skel_desc.root_joint_id)
    rel_univ = absolute_to_root_relative(np.asarray(univ_annot3),
                                         skel_desc.root_joint_id)
    exclude = {'pelvis', 'left_knee', 'left_ankle', 'right_knee', 'right_ankle'}
    include = [i for i, n in enumerate(skel_desc.joint_names) if n not in exclude]
    rel_annot3 = rel_annot3[..., include, :]
    rel_univ = rel_univ[..., include, :]

    non_zero = np.abs(rel_univ) > 1e-6
    ratio = rel_annot3[non_zero] / rel_univ[non_zero]
    # torch.median lower-middle semantics, matching the reference's
    # `ratio.median()` (the ratio count is even in practice)
    scale = torch_median(ratio)
    err_count = (np.abs(rel_annot3 / scale - rel_univ) > 1e-6).sum()
    assert err_count == 0, 'universal scale is not a single factor'
    return scale


def _add_annotation_metadata(f, annot3, univ_annot3, skel_desc):
    f.create_dataset('joints3d', data=np.asarray(annot3, dtype=np.float64))
    scale = calculate_univ_scale_factor(annot3, univ_annot3, skel_desc)
    f.create_dataset('scale', data=np.array([scale], dtype=np.float64))


def process_sequence(in_dir, out_dir, n_frames, blacklist):
    import h5py
    from scipy.io import loadmat

    os.makedirs(out_dir, exist_ok=True)
    for filename in ['annot.mat', 'camera.calibration']:
        dest = path.join(out_dir, filename)
        if not path.exists(dest):
            copy(path.join(in_dir, filename), dest)

    with h5py.File(path.join(out_dir, 'metadata.h5'), 'w') as f:
        annot = Annotations(loadmat(path.join(out_dir, 'annot.mat')))
        _add_annotation_metadata(
            f, annot.annot3[:, :n_frames], annot.univ_annot3[:, :n_frames],
            MpiInf3dhpSkeletonDesc)
        for camera_id in _progress(Constants['vnect_cameras'], 'Cameras'):
            if camera_id in blacklist:
                continue
            process_camera_video(in_dir, out_dir, camera_id, range(n_frames))
            indices = interesting_frame_indices(annot, camera_id, n_frames)
            images_dir = path.join(out_dir, 'imageSequence', 'video_%d' % camera_id)
            indices = [
                i for i in indices
                if is_image_ok(path.join(images_dir, 'img_%06d.jpg' % (i + 1)))
            ]
            f.create_dataset('interesting_frames/camera%d' % camera_id,
                             data=np.asarray(indices, dtype=np.int64))


def preprocess_sequences(src_dir, dest_dir, seqs):
    for subj_id, seq_id in _progress(seqs, 'Sequences'):
        seq_rel_path = path.join('S%d' % subj_id, 'Seq%d' % seq_id)
        process_sequence(
            path.join(src_dir, seq_rel_path),
            path.join(dest_dir, seq_rel_path),
            n_frames=Constants['seq_info'][seq_rel_path]['num_frames'],
            blacklist=Constants['blacklist'].get(seq_rel_path, []),
        )


def preprocess_training_data(src_dir, dest_dir):
    return preprocess_sequences(src_dir, dest_dir, Constants['train_seqs'])


def preprocess_validation_data(src_dir, dest_dir):
    return preprocess_sequences(src_dir, dest_dir, Constants['val_seqs'])


def infer_test_intrinsics(annot2, annot3):
    """Least-squares pinhole intrinsics from 2D/3D correspondences
    (reference: preprocess.py:216-222)."""
    n = annot2.shape[0] * annot2.shape[1]
    x3d = np.stack([annot3[..., 0], annot3[..., 2]], axis=-1).reshape(n, 2)
    x2d = (annot2[..., 0] * annot3[..., 2]).reshape(n, 1)
    fx, cx = np.linalg.lstsq(x3d, x2d, rcond=None)[0].flatten()
    y3d = np.stack([annot3[..., 1], annot3[..., 2]], axis=-1).reshape(n, 2)
    y2d = (annot2[..., 1] * annot3[..., 2]).reshape(n, 1)
    fy, cy = np.linalg.lstsq(y3d, y2d, rcond=None)[0].flatten()
    return fx, fy, cx, cy


def preprocess_test_data(src_dir, dest_dir):
    """(reference: preprocess.py:190-243)"""
    import h5py

    from margipose_tpu_torch.data.mpi3d_raw import RawMpiTestDataset, RawMpiTestSeqDataset

    for seq_id in _progress(RawMpiTestDataset.SEQ_IDS, 'Sequences'):
        dataset = RawMpiTestSeqDataset(src_dir, seq_id, valid_only=True)
        out_dir = path.join(dest_dir, seq_id.replace('TS', 'S'), 'Seq1')
        image_out_dir = path.join(out_dir, 'imageSequence', 'video_0')
        os.makedirs(image_out_dir, exist_ok=True)

        image_width = image_height = -1
        for example in _progress(dataset, 'Images'):
            image = PIL.Image.open(example['image_file'])
            image_width, image_height = image.size
            image = image.resize(
                (int(image_width * 768 / image_height), 768), PIL.Image.LANCZOS)
            image.save(path.join(image_out_dir,
                                 'img_%06d.jpg' % (example['frame_index'] + 1)))

        copy(dataset.annot_file, path.join(out_dir, 'annot_data.mat'))

        with h5py.File(path.join(out_dir, 'metadata.h5'), 'w') as f, \
                h5py.File(dataset.annot_file, 'r') as annot:
            n_frames = len(annot['annot3'])
            annot3 = np.array(annot['annot3']).reshape(1, n_frames, 17, 3)
            univ_annot3 = np.array(annot['univ_annot3']).reshape(1, n_frames, 17, 3)
            annot2 = np.array(annot['annot2']).reshape(1, n_frames, 17, 2)

            fx, fy, cx, cy = infer_test_intrinsics(annot2[0], annot3[0])
            with open(path.join(out_dir, 'camera.calibration'), 'w') as cam_file:
                lines = [
                    'Fake Camera Calibration File',
                    'name          0',
                    '  size        {:d} {:d}'.format(image_width, image_height),
                    '  intrinsic   {:0.3f} 0 {:0.3f} 0 0 {:0.3f} {:0.3f} 0 '
                    '0 0 1 0 0 0 0 1'.format(fx, cx, fy, cy),
                    '  extrinsic   1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1',
                ]
                cam_file.write('\n'.join(lines) + '\n')

            _add_annotation_metadata(f, annot3, univ_annot3, CanonicalSkeletonDesc)

            indices = np.where(np.array(annot['valid_frame']).flatten() == 1)[0]
            f.create_dataset('interesting_frames/camera0',
                             data=indices.astype(np.int64))


def _isolate_person(img, skel2d):
    """Black out everything outside the person bbox (+30px margin)
    (reference: preprocess.py:246-259)."""
    x1, y1 = skel2d.min(axis=0)
    x2, y2 = skel2d.max(axis=0)
    margin = 30
    x1 = max(x1 - margin, 0)
    y1 = max(y1 - margin, 0)
    x2 = min(x2 + margin, 767)
    y2 = min(y2 + margin, 767)
    draw = PIL.ImageDraw.Draw(img)
    draw.rectangle([0, 0, x1, 767], fill=0)
    draw.rectangle([0, 0, 767, y1], fill=0)
    draw.rectangle([x2, 0, 767, 767], fill=0)
    draw.rectangle([0, y2, 767, 767], fill=0)


def preprocess_masks(dir, subj_id, seq_id):
    """Generate foreground / upper-body / lower-body compositing masks
    (reference: preprocess.py:262-322)."""
    import h5py
    from scipy.io import loadmat

    seq_rel_path = path.join('S%d' % subj_id, 'Seq%d' % seq_id)
    seq_dir = path.join(dir, seq_rel_path)
    info = Constants['seq_info'][seq_rel_path]

    interesting_frames = []
    with h5py.File(path.join(seq_dir, 'metadata.h5'), 'r') as f:
        for k in f['interesting_frames'].keys():
            interesting_frames.append(
                (int(k.replace('camera', '')), list(f['interesting_frames'][k])))

    annot = Annotations(loadmat(path.join(seq_dir, 'annot.mat')))

    for camera_id, frame_indices in _progress(interesting_frames, 'Cameras'):
        for frame_index in frame_indices:
            part = 'video_{}/img_{:06d}'.format(camera_id, frame_index + 1)
            img = PIL.Image.open(path.join(seq_dir, f'FGmasks/{part}.jpg'))
            img = PIL.ImageOps.invert(img)
            fg, up_body, low_body = img.split()
            skel2d = annot.annot2[camera_id, frame_index] * 768 / 2048

            if info['bg_augmentable']:
                fg = PIL.ImageOps.invert(fg)
                _isolate_person(fg, skel2d)
                chair = PIL.Image.open(path.join(seq_dir, f'ChairMasks/{part}.png'))
                chair = PIL.ImageOps.invert(chair.split()[0])
                combined = PIL.ImageChops.lighter(fg, chair)
                out_file = path.join(seq_dir, 'foreground_mask', part + '.png')
                os.makedirs(path.dirname(out_file), exist_ok=True)
                combined.save(out_file)

            for enabled, mask, name in [
                (info['ub_augmentable'], up_body, 'up_body_mask'),
                (info['lb_augmentable'], low_body, 'low_body_mask'),
            ]:
                if not enabled:
                    continue
                _isolate_person(mask, skel2d)
                mask = mask.filter(PIL.ImageFilter.MinFilter(3))
                mask = mask.filter(PIL.ImageFilter.MaxFilter(3))
                out_file = path.join(seq_dir, name, part + '.png')
                os.makedirs(path.dirname(out_file), exist_ok=True)
                mask.save(out_file)


def preprocess_training_masks(dir):
    for subj_id, seq_id in _progress(Constants['train_seqs'], 'Sequences'):
        preprocess_masks(dir, subj_id, seq_id)


def preprocess_validation_masks(dir):
    for subj_id, seq_id in _progress(Constants['val_seqs'], 'Sequences'):
        preprocess_masks(dir, subj_id, seq_id)
