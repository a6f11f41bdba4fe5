"""MPII 2D human pose dataset loader (for mixed 2D/3D supervision).

(reference: src/margipose/data/mpii/__init__.py:19-218). The reference used
the external ``torchdata.mpii`` annotation reader; here ``MpiiData``
reimplements that capability surface, reading the widely-used stacked-
hourglass-style h5 annotation files (``annot/{train,valid,test}.h5`` with
center/scale/part/visible/normalize/imgname) from a data directory also
containing ``images/``.
"""

from __future__ import annotations

from os import path

import numpy as np
import PIL.Image

from margipose_tpu_torch.data.base import PoseDataset
from margipose_tpu_torch.data.specs import DataSpecs, ImageSpecs, JointsSpecs
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc, SkeletonDesc

# Standard MPII joint order (torchdata.mpii naming convention)
MPII_Joint_Names = [
    'right_ankle', 'right_knee', 'right_hip', 'left_hip', 'left_knee',
    'left_ankle', 'pelvis', 'spine', 'neck', 'head_top', 'right_wrist',
    'right_elbow', 'right_shoulder', 'left_shoulder', 'left_elbow', 'left_wrist',
]
MPII_Joint_Parents = [1, 2, 6, 6, 3, 4, 6, 6, 7, 8, 11, 12, 7, 7, 13, 14]
MPII_Joint_Horizontal_Flips = [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10]

MpiiSkeletonDesc = SkeletonDesc(
    joint_names=MPII_Joint_Names,
    joint_tree=MPII_Joint_Parents,
    hflip_indices=MPII_Joint_Horizontal_Flips,
)

MPII_TO_CANONICAL = [
    MpiiSkeletonDesc.joint_names.index(s if s != 'head' else 'head_top')
    for s in CanonicalSkeletonDesc.joint_names
]


class MpiiData:
    """Annotation reader with the torchdata.mpii capability surface:
    subset_indices, head_lengths, keypoints, keypoint_masks,
    get_bounding_box, load_image."""

    def __init__(self, data_dir):
        import h5py

        self.data_dir = data_dir
        subsets = {}
        parts, visibles, centers, scales, normalizes, imgnames = [], [], [], [], [], []
        offset = 0
        for subset_name, file_name in [('train', 'train.h5'), ('val', 'valid.h5'),
                                       ('test', 'test.h5')]:
            file_path = path.join(data_dir, 'annot', file_name)
            if not path.isfile(file_path):
                subsets[subset_name] = np.arange(0)
                continue
            with h5py.File(file_path, 'r') as f:
                n = len(f['center'])
                parts.append(np.asarray(f['part'], dtype=np.float64))
                visibles.append(np.asarray(f['visible'], dtype=np.float64)
                                if 'visible' in f else np.ones((n, 16)))
                centers.append(np.asarray(f['center'], dtype=np.float64))
                scales.append(np.asarray(f['scale'], dtype=np.float64))
                normalizes.append(np.asarray(f['normalize'], dtype=np.float64)
                                  if 'normalize' in f else np.full(n, np.nan))
                names = [
                    n.decode() if isinstance(n, bytes) else str(n)
                    for n in np.asarray(f['imgname'])
                ]
                imgnames.extend(names)
            subsets[subset_name] = np.arange(offset, offset + n)
            offset += n

        self.keypoints = np.concatenate(parts) if parts else np.zeros((0, 16, 2))
        self.keypoint_masks = (
            np.concatenate(visibles).astype(np.float32) if visibles else np.zeros((0, 16))
        )
        self.centers = np.concatenate(centers) if centers else np.zeros((0, 2))
        self.scales = np.concatenate(scales) if scales else np.zeros(0)
        self.head_lengths = (
            np.concatenate(normalizes) if normalizes else np.zeros(0)
        )
        self.imgnames = imgnames
        self._subsets = subsets

    def subset_indices(self, subset):
        if subset == 'trainval':
            return np.concatenate([self._subsets['train'], self._subsets['val']])
        return self._subsets[subset]

    def get_bounding_box(self, id):
        """(x0, y0, x1, y1); MPII scale unit is 200 pixels."""
        cx, cy = self.centers[id]
        size = 200.0 * self.scales[id]
        return (cx - size / 2, cy - size / 2, cx + size / 2, cy + size / 2)

    def load_image(self, id):
        return PIL.Image.open(path.join(self.data_dir, 'images', self.imgnames[id]))


class MpiiDataset(PoseDataset):
    def __init__(self, data_dir, data_specs=None, subset='train', use_aug=False,
                 max_length=None, seed=None):
        if data_specs is None:
            data_specs = DataSpecs(
                ImageSpecs(224, mean=ImageSpecs.IMAGENET_MEAN,
                           stddev=ImageSpecs.IMAGENET_STDDEV),
                JointsSpecs(MpiiSkeletonDesc, n_dims=2),
            )
        super().__init__(data_specs)

        self.subset = subset
        self.use_aug = use_aug
        self.mpii_data = MpiiData(data_dir)
        self.example_ids = self.mpii_data.subset_indices(self.subset)[:max_length]
        self._init_example_rng(seed)

    def to_canonical_skeleton(self, skel, force=False):
        """(reference: src/margipose/data/mpii/__init__.py:48-76): canonical
        gather + interpolated 'head' and re-positioned 'spine'."""
        if not force and self.skeleton_desc.canonical:
            return skel
        skel = np.asarray(skel)
        canonical = np.take(skel, MPII_TO_CANONICAL, axis=-2).copy()
        head_top = MpiiSkeletonDesc.joint_names.index('head_top')
        neck = MpiiSkeletonDesc.joint_names.index('neck')
        spine = MpiiSkeletonDesc.joint_names.index('spine')
        pelvis = MpiiSkeletonDesc.joint_names.index('pelvis')
        canonical[..., CanonicalSkeletonDesc.joint_names.index('head'), :] = (
            0.5 * skel[..., head_top, :] + 0.5 * skel[..., neck, :]
        )
        canonical[..., CanonicalSkeletonDesc.joint_names.index('spine'), :] = (
            0.53 * skel[..., spine, :] + 0.47 * skel[..., pelvis, :]
        )
        return canonical

    def to_canonical_mask(self, mask, force=False):
        """(reference: src/margipose/data/mpii/__init__.py:78-97)"""
        if not force and self.skeleton_desc.canonical:
            return mask
        mask = np.asarray(mask)
        canonical = np.take(mask, MPII_TO_CANONICAL, axis=-1).copy()
        head_top = MpiiSkeletonDesc.joint_names.index('head_top')
        neck = MpiiSkeletonDesc.joint_names.index('neck')
        head_idx = CanonicalSkeletonDesc.joint_names.index('head')
        canonical[..., head_idx] = (
            0 if (mask[..., head_top] == 0 or mask[..., neck] == 0) else 1
        )
        return canonical

    def __len__(self):
        return len(self.example_ids)

    def __getitem__(self, index):
        id = self.example_ids[index]
        rng = self.example_rng(index)  # worker-count-invariant (base.py)

        normalize = self.mpii_data.head_lengths[id]
        orig_target = np.asarray(self.mpii_data.keypoints[id], dtype=np.float64)
        joint_mask = np.asarray(self.mpii_data.keypoint_masks[id], dtype=np.float32)

        aug_hflip = False
        colour = {}
        aug_scale = 1
        aug_rot = 0
        if self.use_aug:
            # (reference: src/margipose/data/mpii/__init__.py:115-127)
            aug_hflip = rng.uniform() < 0.5
            if rng.uniform() < 0.3:
                colour['brightness'] = rng.uniform(0.8, 1.2)
            if rng.uniform() < 0.3:
                colour['contrast'] = rng.uniform(0.8, 1.2)
            if rng.uniform() < 0.3:
                colour['saturation'] = rng.uniform(0.8, 1.2)
            if rng.uniform() < 0.3:
                colour['hue'] = rng.uniform(-0.1, 0.1)
            aug_scale = 2 ** float(np.clip(rng.normal(0, 0.25), -0.5, 0.5))
            if rng.uniform() < 0.4:
                aug_rot = float(np.clip(rng.normal(0, 30), -60, 60))

        bb = self.mpii_data.get_bounding_box(id)
        bb_cx = (bb[0] + bb[2]) / 2
        bb_cy = (bb[1] + bb[3]) / 2
        bb_size = bb[2] - bb[0]

        orig_image = self.mpii_data.load_image(id)
        img_short_side = min(orig_image.height, orig_image.width)

        # Fake camera: focal length guess of 1.2x image width
        # (reference: src/margipose/data/mpii/__init__.py:138-144)
        focal_length = orig_image.width * 1.2
        orig_camera = CameraIntrinsics.from_ccd_params(
            focal_length, focal_length, orig_image.width / 2, orig_image.height / 2)
        extrinsics = np.eye(4, dtype=np.float64)

        transform_opts = {
            'in_camera': orig_camera,
            'in_width': orig_image.width,
            'in_height': orig_image.height,
            'centre_x': bb_cx,
            'centre_y': bb_cy,
            'rotation': aug_rot,
            'scale': aug_scale * bb_size / img_short_side,
            'hflip_indices': self.skeleton_desc.hflip_indices,
            'hflip': aug_hflip,
            'out_width': self.data_specs.input_specs.width,
            'out_height': self.data_specs.input_specs.height,
            'brightness': colour.get('brightness', 1),
            'contrast': colour.get('contrast', 1),
            'saturation': colour.get('saturation', 1),
            'hue': colour.get('hue', 0),
        }

        if self.skeleton_desc.canonical:
            orig_target = self.to_canonical_skeleton(orig_target, force=True)
            joint_mask = self.to_canonical_mask(joint_mask, force=True)

        # Lift 2D keypoints into fake camera space with z = focal length
        # (reference: src/margipose/data/mpii/__init__.py:170-175)
        n_joints = orig_target.shape[-2]
        lifted = np.ones((n_joints, 4), dtype=np.float64)
        lifted[:, 0] = orig_target[:, 0] - orig_image.width / 2
        lifted[:, 1] = orig_target[:, 1] - orig_image.height / 2
        lifted[:, 2] = focal_length
        orig_target = lifted

        ctx = self.create_transformer_context(transform_opts)
        use_device_aug = self.device_aug and not getattr(self, 'multicrop', False)
        host_image = None if use_device_aug else orig_image
        camera_int, img, part_coords = ctx.transform(orig_camera, host_image, orig_target)

        z_ref = part_coords[self.skeleton_desc.root_joint_id, 2]
        part_coords = self.skeleton_normaliser.normalise_skeleton(
            part_coords, z_ref, camera_int,
            transform_opts['out_height'], transform_opts['out_width'])

        if aug_hflip:
            # Relabel masks to match the flipped joints
            # (reference: src/margipose/data/mpii/__init__.py:185-187)
            joint_mask = joint_mask[np.asarray(self.skeleton_desc.hflip_indices)]

        # Mask joints transformed outside image bounds
        # (reference: src/margipose/data/mpii/__init__.py:196-198)
        if self.subset in ('train', 'trainval'):
            within = (np.abs(part_coords[:, :2]) < 1).all(axis=-1)
            joint_mask = joint_mask * within.astype(np.float32)

        sample = {
            'index': index,
            'valid_depth': 0,
            'normalize': normalize,
            'joint_mask': joint_mask.astype(np.float32),
            'camera_intrinsic': camera_int,
            'camera_extrinsic': extrinsics,
            'transform_opts': transform_opts,
            'original_skel': orig_target,
            'target': part_coords.astype(np.float32),
        }
        if use_device_aug:
            # variable-size MPII frames are letterboxed onto the shared
            # canvas inside device_aug_fields
            sample.update(self.device_aug_fields(ctx, orig_image))
        else:
            sample['input'] = self.input_to_tensor(img)
        return sample

    def to_canonical_skeleton_public(self, skel):
        return self.to_canonical_skeleton(skel)


# Source archives for install_mpii_dataset (the torchdata.mpii capability
# surface; reference usage: README.md:53-54). The annotation h5s follow the
# stacked-hourglass convention that MpiiData reads.
MPII_IMAGES_URL = ('https://datasets.d2.mpi-inf.mpg.de/andriluka14cvpr/'
                   'mpii_human_pose_v1.tar.gz')
MPII_ANNOT_URLS = {
    'train.h5': 'https://github.com/princeton-vl/pose-hg-train/raw/master/data/mpii/annot/train.h5',
    'valid.h5': 'https://github.com/princeton-vl/pose-hg-train/raw/master/data/mpii/annot/valid.h5',
    'test.h5': 'https://github.com/princeton-vl/pose-hg-train/raw/master/data/mpii/annot/test.h5',
}


def install_mpii_dataset(data_dir, skip_images=False):
    """Download and lay out the MPII dataset under ``data_dir``
    (``annot/{train,valid,test}.h5`` + ``images/``), the equivalent of
    torchdata's ``mpii.install_mpii_dataset`` (reference: README.md:53-54).

    Idempotent: files already present are kept. Returns the list of files
    it actually downloaded (empty when everything was in place)."""
    import os
    import tarfile
    import urllib.request

    downloaded = []
    annot_dir = path.join(data_dir, 'annot')
    os.makedirs(annot_dir, exist_ok=True)
    for name, url in MPII_ANNOT_URLS.items():
        dest = path.join(annot_dir, name)
        if path.isfile(dest):
            continue
        tmp = dest + '.part'
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, dest)
        downloaded.append(dest)

    images_dir = path.join(data_dir, 'images')
    if not skip_images and not path.isdir(images_dir):
        tar_path = path.join(data_dir, 'mpii_human_pose_v1.tar.gz')
        if not path.isfile(tar_path):
            urllib.request.urlretrieve(MPII_IMAGES_URL, tar_path + '.part')
            os.replace(tar_path + '.part', tar_path)
            downloaded.append(tar_path)
        with tarfile.open(tar_path) as tf:
            try:
                tf.extractall(data_dir, filter='data')
            except TypeError:  # filter= needs Python >= 3.10.12 / 3.11.4
                tf.extractall(data_dir)
    return downloaded
