"""Procedural miniature MPI-INF-3DHP dataset in the processed on-disk layout.

Generates exactly what ``margipose_preprocess_mpi3d`` would write
(reference: src/margipose/data/mpi_inf_3dhp/preprocess.py:128-134,246-322):
per-sequence ``metadata.h5`` (interesting_frames, scale, joints3d),
``camera.calibration``, extracted JPEG frames, and the foreground /
up-body / low-body augmentation masks — so the REAL ``MpiInf3dDataset``
(including compositing augmentation and multicrop) can run in tests and
benchmarks without the 25 GB original dataset.

The base pose is the S1/Seq1/camera0/frame0 28-joint skeleton from the
reference's own test fixtures (reference: tests/conftest.py:36-65) with
per-frame jitter large enough to pass the >=200 mm "interesting frame"
movement criterion.

The port's copy of ``margipose_tpu/data/fake_mpi3d.py``.
"""

from __future__ import annotations

import os
from os import path

import numpy as np
import PIL.Image
import PIL.ImageDraw
import PIL.ImageOps

# 28-joint camera-space pose in mm (reference: tests/conftest.py:36-65 —
# the universal-scale S1/Seq1 frame-0 skeleton; a numeric contract).
BASE_POSE_28 = np.array([
    [-26.0276, 98.0811, 3699.60], [-45.5924, -6.8788, 3691.51],
    [-11.8660, 175.6800, 3705.06], [-11.7886, 176.2583, 3705.0914],
    [1.6757, 402.9290, 3713.26], [-1.8908, -78.7086, 3697.48],
    [11.9904, -164.0930, 3696.26], [-14.1671, -334.8410, 3685.41],
    [10.8534, -43.9395, 3744.14], [-21.9359, 6.5647, 3823.57],
    [-48.9321, 9.3914, 4139.38], [-48.1227, 29.9672, 4383.52],
    [-57.2134, 51.5208, 4469.82], [27.8253, -40.3641, 3662.90],
    [12.3105, -6.8914, 3570.30], [28.6693, 53.3262, 3259.53],
    [65.5078, 80.3900, 3018.83], [74.3912, 90.6255, 2930.45],
    [-22.8190, 401.2070, 3829.8625], [-45.7490, 956.8290, 3800.59],
    [-137.3620, 1388.2400, 3780.20], [-43.9510, 1416.6700, 3807.94],
    [-17.2509, 1412.7200, 3812.42], [26.1703, 404.6510, 3596.6575],
    [-15.4026, 957.8070, 3670.33], [-87.2411, 1390.7700, 3718.40],
    [10.3942, 1414.7500, 3704.42], [36.6540, 1407.8400, 3701.05],
], dtype=np.float64)

FOCAL = 1500.0
SENSOR = 2048.0  # original capture resolution; frames stored at 768


def _calibration_text(camera_ids):
    lines = ["Fake calibration file"]
    for cid in camera_ids:
        intr = np.eye(4)
        intr[0, 0] = intr[1, 1] = FOCAL
        intr[0, 2] = intr[1, 2] = SENSOR / 2
        extr = np.eye(4)
        lines += [
            f"name          {cid}",
            "sensor        10 10",
            f"size          {SENSOR:.0f} {SENSOR:.0f}",
            "animated      0",
            "intrinsic     " + " ".join(f"{v:.6f}" for v in intr.flatten()),
            "extrinsic     " + " ".join(f"{v:.6f}" for v in extr.flatten()),
            "radial        0",
        ]
    return "\n".join(lines) + "\n"


def _person_bbox(pose, img_size):
    """Projected 2D bbox of the pose at the stored image resolution."""
    scale = img_size / SENSOR
    pts = pose[:, :2] / pose[:, 2:3] * FOCAL + SENSOR / 2
    pts = pts * scale
    return (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())


def _render_frame(rng, pose, img_size):
    """Procedural frame: noisy background + a filled person-ish silhouette."""
    img = PIL.Image.new(
        'RGB', (img_size, img_size),
        tuple(int(c) for c in rng.randint(30, 120, 3)))
    draw = PIL.ImageDraw.Draw(img)
    x0, y0, x1, y1 = _person_bbox(pose, img_size)
    draw.ellipse([x0, y0, x1, y1], fill=(170, 130, 100))
    # limbs as lines for texture
    scale = img_size / SENSOR
    pts = pose[:, :2] / pose[:, 2:3] * FOCAL + SENSOR / 2
    for a in range(0, len(pts) - 1, 2):
        draw.line([tuple(pts[a] * scale), tuple(pts[a + 1] * scale)],
                  fill=(90, 60, 40), width=3)
    return img


def _render_masks(pose, img_size):
    """fg / upper-body / lower-body masks around the projected pose."""
    x0, y0, x1, y1 = _person_bbox(pose, img_size)
    ymid = (y0 + y1) / 2
    masks = {}
    for name, box in (
            ('fg', [x0, y0, x1, y1]),
            ('ub', [x0, y0, x1, ymid]),
            ('lb', [x0, ymid, x1, y1])):
        m = PIL.Image.new('L', (img_size, img_size), 0)
        PIL.ImageDraw.Draw(m).ellipse(box, fill=255)
        masks[name] = m
    return masks


def generate_fake_mpi3d(out_dir, seqs=((1, 1),), camera_ids=(0, 2),
                        n_frames=4, img_size=768, seed=0,
                        with_images=True, with_activities=False):
    """Write a miniature processed-layout MPI-INF-3DHP dataset to ``out_dir``.

    Frames jitter the base pose by >200 mm translation steps so every frame
    passes the reference's interesting-frame criterion. With
    ``with_activities`` an ``annot_data.mat`` (HDF5/v7.3) carrying per-frame
    activity ids is written, as in the preprocessed test set. Returns
    ``out_dir``.
    """
    import h5py

    rng = np.random.RandomState(seed)
    n_cameras = 14
    for subject_id, sequence_id in seqs:
        seq_dir = path.join(out_dir, f'S{subject_id}', f'Seq{sequence_id}')
        os.makedirs(seq_dir, exist_ok=True)

        joints3d = np.zeros((n_cameras, n_frames, 28, 3))
        poses = []
        for t in range(n_frames):
            # walk sideways >=250mm per frame; stays well inside the frame
            offset = np.array([(t - n_frames / 2) * 260.0,
                               rng.uniform(-40, 40), rng.uniform(-60, 60)])
            poses.append(BASE_POSE_28 + offset)
        for cid in camera_ids:
            for t in range(n_frames):
                joints3d[cid, t] = poses[t]

        with h5py.File(path.join(seq_dir, 'metadata.h5'), 'w') as f:
            f['scale'] = np.array([1.05])
            f['joints3d'] = joints3d
            grp = f.create_group('interesting_frames')
            for cid in camera_ids:
                grp[f'camera{cid}'] = np.arange(n_frames, dtype=np.int64)

        with open(path.join(seq_dir, 'camera.calibration'), 'w') as f:
            f.write(_calibration_text(camera_ids))

        if with_activities:
            with h5py.File(path.join(seq_dir, 'annot_data.mat'), 'w') as f:
                f['activity_annotation'] = (
                    np.arange(n_frames, dtype=np.float64) % 8 + 1).reshape(1, -1)

        if not with_images:
            continue
        for cid in camera_ids:
            img_dir = path.join(seq_dir, 'imageSequence', f'video_{cid}')
            os.makedirs(img_dir, exist_ok=True)
            mask_dirs = {
                'fg': path.join(seq_dir, 'foreground_mask', f'video_{cid}'),
                'ub': path.join(seq_dir, 'up_body_mask', f'video_{cid}'),
                'lb': path.join(seq_dir, 'low_body_mask', f'video_{cid}'),
            }
            for d in mask_dirs.values():
                os.makedirs(d, exist_ok=True)
            for t in range(n_frames):
                img = _render_frame(rng, poses[t], img_size)
                img.save(path.join(img_dir, f'img_{t + 1:06d}.jpg'),
                         quality=90)
                for name, m in _render_masks(poses[t], img_size).items():
                    m.save(path.join(mask_dirs[name], f'img_{t + 1:06d}.png'))
    return out_dir


def generate_fake_raw_mpi3d_test(out_dir, n_frames=3, img_size=512, seed=0):
    """Write a miniature RAW MPI-INF-3DHP test set (TS1..TS6) to ``out_dir``,
    in the layout ``margipose_preprocess_mpi3d -t`` consumes
    (reference: src/margipose/data/mpi_inf_3dhp/raw.py,
    src/margipose/bin/preprocess_mpi3d.py:190-243): per-sequence
    ``annot_data.mat`` (HDF5/v7.3 with valid_frame, activity_annotation, and
    17-joint annot2/annot3/univ_annot3) plus ``imageSequence/img_NNNNNN.jpg``.

    annot2 is an exact pinhole projection of annot3 so the preprocessor's
    least-squares intrinsics inference recovers the camera, and univ_annot3
    is root-relative annot3 scaled by exactly 1/1.05 so the universal-scale
    factor computation succeeds. The last frame is marked invalid to exercise
    the valid-frame filter. Returns ``out_dir``.
    """
    import h5py

    from margipose_tpu_torch.data.mpi_inf_3dhp import MPI3D_TO_CANONICAL
    from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc

    rng = np.random.RandomState(seed)
    focal = img_size * 1.0
    centre = img_size / 2.0
    base_pose_17 = BASE_POSE_28[MPI3D_TO_CANONICAL]
    root_id = CanonicalSkeletonDesc.root_joint_id
    scale = 1.05

    for seq_id in ('TS1', 'TS2', 'TS3', 'TS4', 'TS5', 'TS6'):
        seq_dir = path.join(out_dir, seq_id)
        img_dir = path.join(seq_dir, 'imageSequence')
        os.makedirs(img_dir, exist_ok=True)

        annot3 = np.zeros((n_frames, 1, 17, 3))
        poses = []
        for t in range(n_frames):
            offset = np.array([(t - n_frames / 2) * 260.0,
                               rng.uniform(-40, 40), rng.uniform(-60, 60)])
            pose = base_pose_17 + offset
            poses.append(pose)
            annot3[t, 0] = pose
        annot2 = annot3[..., :2] / annot3[..., 2:3] * focal + centre
        root = annot3[:, :, root_id:root_id + 1, :]
        univ_annot3 = (annot3 - root) / scale + root
        valid = np.ones((n_frames, 1), np.float64)
        valid[-1] = 0  # exercise the valid-frame filter

        with h5py.File(path.join(seq_dir, 'annot_data.mat'), 'w') as f:
            f['annot2'] = annot2
            f['annot3'] = annot3
            f['univ_annot3'] = univ_annot3
            f['valid_frame'] = valid
            f['activity_annotation'] = (
                np.arange(n_frames, dtype=np.float64) % 8 + 1).reshape(-1, 1)

        for t in range(n_frames):
            # raw test frames are full-resolution; the preprocessor resizes
            # them to height 768 (reference: preprocess.py:198-204)
            img = PIL.Image.new(
                'RGB', (img_size, img_size),
                tuple(int(c) for c in rng.randint(30, 120, 3)))
            draw = PIL.ImageDraw.Draw(img)
            pts = annot2[t, 0]
            x0, y0 = pts.min(axis=0)
            x1, y1 = pts.max(axis=0)
            draw.ellipse([x0, y0, x1, y1], fill=(170, 130, 100))
            img.save(path.join(img_dir, f'img_{t + 1:06d}.jpg'), quality=90)
    return out_dir


def generate_fake_raw_mpi3d_train(out_dir, proc_dir, subj_id=2, seq_id=2,
                                  n_frames=3, seed=0):
    """Write a miniature RAW MPI-INF-3DHP training sequence plus the
    pre-extracted frames the preprocessor's resume path expects, so the full
    train/val preprocessing (annot.mat ingestion, metadata.h5, interesting
    frames, mask generation) runs without ffmpeg
    (reference: src/margipose/data/mpi_inf_3dhp/preprocess.py:39-76 skips
    extraction when the wanted frames already exist in the output dir).

    ``out_dir`` gets the raw ``S{s}/Seq{q}`` with ``annot.mat`` (MATLAB v5 via
    scipy.io.savemat, 28-joint cell-per-camera layout) and
    ``camera.calibration``; ``proc_dir`` gets ``imageSequence`` JPEG frames
    plus raw ``FGmasks`` (inverted fg/ub/lb channels) and ``ChairMasks`` for
    every VNect camera. Returns ``(raw_seq_dir, proc_seq_dir)``.
    """
    import scipy.io

    from margipose_tpu_torch.data.mpi_inf_3dhp import Constants

    rng = np.random.RandomState(seed)
    raw_seq = path.join(out_dir, f'S{subj_id}', f'Seq{seq_id}')
    proc_seq = path.join(proc_dir, f'S{subj_id}', f'Seq{seq_id}')
    os.makedirs(raw_seq, exist_ok=True)

    n_cameras = Constants['n_cameras']
    poses = []
    for t in range(n_frames):
        offset = np.array([(t - n_frames / 2) * 260.0,
                           rng.uniform(-40, 40), rng.uniform(-60, 60)])
        poses.append(BASE_POSE_28 + offset)

    def cells(ndims):
        arr = np.empty((n_cameras, 1), dtype=object)
        for cid in range(n_cameras):
            per_cam = np.zeros((n_frames, 28 * ndims))
            for t in range(n_frames):
                p = poses[t]
                if ndims == 2:
                    p = p[:, :2] / p[:, 2:3] * FOCAL + SENSOR / 2
                per_cam[t] = p[:, :ndims].reshape(-1)
            arr[cid, 0] = per_cam
        return arr

    annot3 = cells(3)
    univ = np.empty((n_cameras, 1), dtype=object)
    for cid in range(n_cameras):
        a3 = annot3[cid, 0].reshape(n_frames, 28, 3)
        r = a3[:, 14:15, :]
        univ[cid, 0] = ((a3 - r) / 1.05 + r).reshape(n_frames, -1)
    scipy.io.savemat(path.join(raw_seq, 'annot.mat'), {
        'cameras': np.arange(n_cameras).reshape(-1, 1),
        'frames': np.arange(n_frames).reshape(-1, 1),
        'annot3': annot3,
        'univ_annot3': univ,
        'annot2': cells(2),
    })
    with open(path.join(raw_seq, 'camera.calibration'), 'w') as f:
        f.write(_calibration_text(range(n_cameras)))

    # Pre-extracted 768px frames + raw mask videos' frames in the OUTPUT dir
    # (the state an interrupted ffmpeg preprocessing run leaves behind).
    for cid in Constants['vnect_cameras']:
        img_dir = path.join(proc_seq, 'imageSequence', f'video_{cid}')
        fg_dir = path.join(proc_seq, 'FGmasks', f'video_{cid}')
        chair_dir = path.join(proc_seq, 'ChairMasks', f'video_{cid}')
        for d in (img_dir, fg_dir, chair_dir):
            os.makedirs(d, exist_ok=True)
        for t in range(n_frames):
            _render_frame(rng, poses[t], 768).save(
                path.join(img_dir, f'img_{t + 1:06d}.jpg'), quality=90)
            masks = _render_masks(poses[t], 768)
            # FGmasks store INVERTED (fg, ub, lb) as RGB channels
            # (reference: preprocess.py:262-322 inverts after loading)
            inv = PIL.Image.merge('RGB', [
                PIL.ImageOps.invert(masks['fg']),
                PIL.ImageOps.invert(masks['ub']),
                PIL.ImageOps.invert(masks['lb'])])
            inv.save(path.join(fg_dir, f'img_{t + 1:06d}.jpg'), quality=95)
            # no chair: stored ChairMasks are all-white (inverts to empty)
            PIL.Image.new('RGB', (768, 768), (255, 255, 255)).save(
                path.join(chair_dir, f'img_{t + 1:06d}.png'))
    return raw_seq, proc_seq
