"""Procedural miniature H36M / MPII datasets in their processed layouts.

Companions to ``fake_mpi3d.py``: generate exactly what the real dataset
classes consume — H36M's per-sequence ``annot.h5`` + extracted frames
(reference: src/margipose/data/h36m/__init__.py:126-176) and MPII's
hourglass-style ``annot/{train,valid,test}.h5`` + ``images/`` — so
``H36MDataset`` / ``MpiiDataset`` run in tests without the real data.

The port's copy of ``margipose_tpu/data/fakes.py``.
"""

from __future__ import annotations

import os
from os import path

import numpy as np
import PIL.Image
import PIL.ImageDraw

from margipose_tpu_torch.data.fake_mpi3d import BASE_POSE_28

# name-based mapping 28-joint MPI pose -> 32-joint H36M pose; H36M-only
# joints borrow the nearest named MPI joint.
_MPI_NAMES = [
    'spine3', 'spine4', 'spine2', 'spine', 'pelvis', 'neck', 'head',
    'head_top', 'left_clavicle', 'left_shoulder', 'left_elbow', 'left_wrist',
    'left_hand', 'right_clavicle', 'right_shoulder', 'right_elbow',
    'right_wrist', 'right_hand', 'left_hip', 'left_knee', 'left_ankle',
    'left_foot', 'left_toe', 'right_hip', 'right_knee', 'right_ankle',
    'right_foot', 'right_toe',
]
_H36M_FROM_MPI = [
    'pelvis', 'right_hip', 'right_knee', 'right_ankle',
    'right_toe', 'right_toe', 'left_hip', 'left_knee',
    'left_ankle', 'left_toe', 'left_toe', 'spine',
    'spine2', 'neck', 'head', 'head_top',
    'left_clavicle', 'left_shoulder', 'left_elbow', 'left_wrist',
    'left_hand', 'left_hand', 'left_wrist', 'left_hand',
    'right_clavicle', 'right_shoulder', 'right_elbow', 'right_wrist',
    'right_hand', 'right_hand', 'right_wrist', 'right_hand',
]
BASE_POSE_H36M = BASE_POSE_28[[_MPI_NAMES.index(n) for n in _H36M_FROM_MPI]]

_F = 1150.0
_IMG = 1000  # H36M frames are ~1000x1000


def _draw_pose(img, pts, fill=(170, 130, 100)):
    draw = PIL.ImageDraw.Draw(img)
    x0, y0 = pts[:, 0].min(), pts[:, 1].min()
    x1, y1 = pts[:, 0].max(), pts[:, 1].max()
    draw.ellipse([x0, y0, x1, y1], fill=fill)
    for a in range(0, len(pts) - 1, 2):
        draw.line([tuple(pts[a]), tuple(pts[a + 1])], fill=(90, 60, 40), width=3)


def generate_fake_h36m(out_dir, subjects=(1, 9), action=14, subaction=1,
                       camera_ids=(54138969 % 100, 2), n_frames=3, seed=0,
                       with_images=True):
    """Write a miniature processed H36M dataset. Uses action 14 ('Walking').

    Layout per sequence dir ``S{s}/Walking-{sub}``: ``annot.h5`` with
    pose/2d, pose/3d, pose/3d-univ, intrinsics[-univ]/{cam}, camera, frame,
    subject, action, subaction; frames at ``imageSequence/{cam}/img_NNNNNN.jpg``.
    """
    import h5py

    rng = np.random.RandomState(seed)
    from margipose_tpu_torch.data.h36m import H36M_Actions

    act_name = H36M_Actions[action]
    for s in subjects:
        seq_dir = path.join(out_dir, f'S{s}', f'{act_name}-{subaction}')
        os.makedirs(seq_dir, exist_ok=True)
        n = n_frames * len(camera_ids)
        pose3d = np.zeros((n, 32, 3))
        pose2d = np.zeros((n, 32, 2))
        cams, frames = [], []
        i = 0
        poses = [BASE_POSE_H36M + np.array([(t - n_frames / 2) * 200.0,
                                            rng.uniform(-30, 30),
                                            rng.uniform(-50, 50)])
                 for t in range(n_frames)]
        for cid in camera_ids:
            for t in range(n_frames):
                p = poses[t]
                pose3d[i] = p
                pose2d[i] = p[:, :2] / p[:, 2:3] * _F + _IMG / 2
                cams.append(cid)
                frames.append(t + 1)
                i += 1
        with h5py.File(path.join(seq_dir, 'annot.h5'), 'w') as f:
            f['pose/2d'] = pose2d
            f['pose/3d'] = pose3d
            f['pose/3d-univ'] = pose3d * 1.02
            f['camera'] = np.asarray(cams, np.int64)
            f['frame'] = np.asarray(frames, np.int64)
            f['subject'] = np.full(n, s, np.int64)
            f['action'] = np.full(n, action, np.int64)
            f['subaction'] = np.full(n, subaction, np.int64)
            for grp in ('intrinsics', 'intrinsics-univ'):
                g = f.create_group(grp)
                for cid in camera_ids:
                    g[str(cid)] = np.asarray([_F, _IMG / 2, _F, _IMG / 2])
        if not with_images:
            continue
        for cid in camera_ids:
            img_dir = path.join(seq_dir, 'imageSequence', str(cid))
            os.makedirs(img_dir, exist_ok=True)
            for t in range(n_frames):
                img = PIL.Image.new(
                    'RGB', (_IMG, _IMG),
                    tuple(int(c) for c in rng.randint(30, 120, 3)))
                pts = poses[t][:, :2] / poses[t][:, 2:3] * _F + _IMG / 2
                _draw_pose(img, pts)
                img.save(path.join(img_dir, f'img_{t + 1:06d}.jpg'), quality=90)
    return out_dir


def generate_fake_mpii(out_dir, n_train=4, n_val=2, img_size=512, seed=0):
    """Write a miniature MPII dataset: ``annot/{train,valid}.h5`` in the
    hourglass format + ``images/``. 16 MPII joints per example."""
    import h5py

    rng = np.random.RandomState(seed)
    os.makedirs(path.join(out_dir, 'annot'), exist_ok=True)
    os.makedirs(path.join(out_dir, 'images'), exist_ok=True)
    counter = 0

    def make_subset(file_name, n):
        nonlocal counter
        parts = np.zeros((n, 16, 2))
        centers = np.zeros((n, 2))
        scales = np.zeros(n)
        normalize = np.zeros(n)
        names = []
        for i in range(n):
            cx, cy = rng.uniform(img_size * 0.35, img_size * 0.65, 2)
            height = rng.uniform(img_size * 0.3, img_size * 0.5)
            # crude standing person: head at top, feet at bottom
            ys = np.linspace(cy - height / 2, cy + height / 2, 16)
            xs = cx + rng.uniform(-height / 6, height / 6, 16)
            parts[i] = np.stack([xs, ys], axis=-1)
            centers[i] = (cx, cy)
            scales[i] = height / 200.0
            normalize[i] = height * 0.1
            name = f'img_{counter:05d}.jpg'
            counter += 1
            names.append(name)
            img = PIL.Image.new(
                'RGB', (img_size, img_size),
                tuple(int(c) for c in rng.randint(30, 120, 3)))
            _draw_pose(img, parts[i])
            img.save(path.join(out_dir, 'images', name), quality=90)
        with h5py.File(path.join(out_dir, 'annot', file_name), 'w') as f:
            f['part'] = parts
            f['visible'] = np.ones((n, 16))
            f['center'] = centers
            f['scale'] = scales
            f['normalize'] = normalize
            f['imgname'] = np.asarray([n.encode() for n in names])

    make_subset('train.h5', n_train)
    make_subset('valid.h5', n_val)
    return out_dir
