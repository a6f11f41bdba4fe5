"""MPI-INF-3DHP dataset loader (primary 3D train/eval dataset).

(reference: src/margipose/data/mpi_inf_3dhp/__init__.py:20-429 and
src/margipose/data/mpi_inf_3dhp/common.py:11-136). Consumes the processed
layout written by ``margipose_preprocess_mpi3d``: per-sequence
``metadata.h5`` (interesting frames, universal scale, joints3d),
``camera.calibration``, and extracted JPEG frames.
"""

from __future__ import annotations

import json
import os
import re
from glob import iglob
from os import path

import numpy as np
import PIL.Image
from PIL import ImageOps

from margipose_tpu_torch.data.base import PoseDataset, as_rgb_array, collate
from margipose_tpu_torch.data.specs import DataSpecs, ImageSpecs, JointsSpecs
from margipose_tpu_torch.eval import gather_3d_metrics, prepare_for_3d_evaluation
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.geometry.skeleton import (
    CanonicalSkeletonDesc,
    SkeletonDesc,
    VNect_Common_Skeleton,
)


def _load_seq_info():
    info_file = path.join(path.dirname(__file__), 'mpi3d_sequence_info.json')
    with open(info_file) as f:
        return json.load(f)


Constants = {
    # Training set sequences (reference: common.py:13-16)
    'train_seqs': [
        (1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (4, 2),
        (5, 1), (5, 2), (6, 1), (6, 2), (7, 1), (7, 2), (8, 1),
    ],
    'val_seqs': [(4, 1), (8, 2)],
    # Camera IDs used for training/validation (same as VNect)
    'vnect_cameras': [0, 1, 2, 4, 5, 6, 7, 8],
    'n_cameras': 14,
    'seq_info': _load_seq_info(),
    # Root joint index (pelvis) for training/validation data
    'root_joint': 4,
    'blacklist': {
        'S6/Seq2': [2],  # imageSequence/video_2.avi is too short
    },
}

# 28-joint training/validation skeleton (reference: common.py:35-70)
MpiInf3dhpSkeletonDesc = SkeletonDesc(
    joint_names=[
        'spine3', 'spine4', 'spine2', 'spine',
        'pelvis', 'neck', 'head', 'head_top',
        'left_clavicle', 'left_shoulder', 'left_elbow', 'left_wrist',
        'left_hand', 'right_clavicle', 'right_shoulder', 'right_elbow',
        'right_wrist', 'right_hand', 'left_hip', 'left_knee',
        'left_ankle', 'left_foot', 'left_toe', 'right_hip',
        'right_knee', 'right_ankle', 'right_foot', 'right_toe',
    ],
    joint_tree=[
        2, 0, 3, 4,
        4, 1, 5, 6,
        5, 8, 9, 10,
        11, 5, 13, 14,
        15, 16, 4, 18,
        19, 20, 21, 4,
        23, 24, 25, 26,
    ],
    hflip_indices=[
        0, 1, 2, 3,
        4, 5, 6, 7,
        13, 14, 15, 16,
        17, 8, 9, 10,
        11, 12, 23, 24,
        25, 26, 27, 18,
        19, 20, 21, 22,
    ],
)

MPI3D_TO_CANONICAL = [
    MpiInf3dhpSkeletonDesc.joint_names.index(name)
    for name in CanonicalSkeletonDesc.joint_names
]


def parse_camera_calibration(f) -> dict:
    """Parse an mpi3d camera.calibration text file
    (reference: common.py:88-136)."""
    line_re = re.compile(r'(\w+)\s+(.+)')
    types = {
        'name': 'int', 'sensor': 'vec2', 'size': 'vec2', 'animated': 'int',
        'intrinsic': 'mat4', 'extrinsic': 'mat4', 'radial': 'int',
    }
    f.readline()
    camera_properties = {}
    props = None
    for line in f.readlines():
        m = line_re.fullmatch(line.strip())
        if not m:
            continue
        key, value = m.groups()
        values = value.split(' ')
        value_type = types.get(key)
        if value_type == 'int':
            parsed = int(values[0])
        elif value_type == 'vec2':
            parsed = np.array([float(v) for v in values])
        elif value_type == 'mat4':
            parsed = np.array([float(v) for v in values]).reshape((4, 4))
        else:
            continue
        if key == 'name':
            props = {}
            camera_properties[parsed] = props
        else:
            props[key] = parsed

    cameras = {}
    for i, props in camera_properties.items():
        cameras[i] = {
            'intrinsics': CameraIntrinsics(props['intrinsic'][:3]),
            'extrinsics': props['extrinsic'],
            'image_width': props['size'][0],
            'image_height': props['size'][1],
        }
    return cameras


class FrameRef:
    """(reference: src/margipose/data/mpi_inf_3dhp/__init__.py:20-86)"""

    def __init__(self, subject_id, sequence_id, camera_id, frame_index, activity_id=None):
        self.subject_id = subject_id
        self.sequence_id = sequence_id
        self.camera_id = camera_id
        self.frame_index = frame_index
        self.activity_id = activity_id

    @property
    def image_file(self):
        return 'S{}/Seq{}/imageSequence/video_{}/img_{:06d}.jpg'.format(
            self.subject_id, self.sequence_id, self.camera_id, self.frame_index + 1)

    @property
    def bg_mask_file(self):
        return 'S{}/Seq{}/foreground_mask/video_{}/img_{:06d}.png'.format(
            self.subject_id, self.sequence_id, self.camera_id, self.frame_index + 1)

    @property
    def ub_mask_file(self):
        return 'S{}/Seq{}/up_body_mask/video_{}/img_{:06d}.png'.format(
            self.subject_id, self.sequence_id, self.camera_id, self.frame_index + 1)

    @property
    def lb_mask_file(self):
        return 'S{}/Seq{}/low_body_mask/video_{}/img_{:06d}.png'.format(
            self.subject_id, self.sequence_id, self.camera_id, self.frame_index + 1)

    @property
    def annot_file(self):
        return 'S{}/Seq{}/annot.mat'.format(self.subject_id, self.sequence_id)

    @property
    def camera_file(self):
        return 'S{}/Seq{}/camera.calibration'.format(self.subject_id, self.sequence_id)

    @property
    def metadata_file(self):
        return 'S{}/Seq{}/metadata.h5'.format(self.subject_id, self.sequence_id)

    def _seq_info(self):
        return Constants['seq_info']['S{}/Seq{}'.format(self.subject_id, self.sequence_id)]

    @property
    def bg_augmentable(self):
        return self._seq_info()['bg_augmentable'] == 1

    @property
    def ub_augmentable(self):
        return self._seq_info()['ub_augmentable'] == 1

    @property
    def lb_augmentable(self):
        return self._seq_info()['lb_augmentable'] == 1

    def to_dict(self):
        return {
            'subject_id': self.subject_id,
            'sequence_id': self.sequence_id,
            'camera_id': self.camera_id,
            'frame_index': self.frame_index,
            'activity_id': self.activity_id,
        }


def resources_dir() -> str:
    """Directory holding augmentation assets (backgrounds/, textures/).
    Configurable via MARGIPOSE_RESOURCES_DIR; defaults to ./resources like
    the reference (reference: src/margipose/data/mpi_inf_3dhp/__init__.py:90,114)."""
    return os.environ.get('MARGIPOSE_RESOURCES_DIR', 'resources')


_RESOURCE_LISTS: dict = {}


def _resource_files(kind: str, pattern: str) -> list:
    """Cached directory listing — the loader calls this per augmented sample
    and a glob per sample is measurable at full augmentation rates."""
    key = (resources_dir(), kind)
    files = _RESOURCE_LISTS.get(key)
    if not files:
        files = sorted(iglob(path.join(resources_dir(), pattern)))
        if files:  # never cache a miss: assets may appear later in-process
            _RESOURCE_LISTS[key] = files
    return files


def random_texture(rng: np.random.RandomState):
    files = _resource_files('textures', 'textures/*.png')
    if not files:
        return None
    file = files[rng.randint(0, len(files))]
    texture = PIL.Image.open(file).convert('L')
    return ImageOps.colorize(
        texture, 'black',
        (rng.randint(50, 256), rng.randint(50, 256), rng.randint(50, 256)),
    )


def _as_mask_array(mask) -> np.ndarray:
    if isinstance(mask, np.ndarray):
        return mask
    return np.asarray(mask.convert('L') if mask.mode != 'L' else mask)


def _composite(fg, bg, mask) -> np.ndarray:
    """PIL.Image.composite semantics on HWC uint8 arrays, with the fused
    C++ path when available. The whole compositing pipeline stays in numpy
    (one decode-time conversion per image instead of a PIL<->numpy round
    trip per stage)."""
    from margipose_tpu_torch import native

    fg, bg, mask = as_rgb_array(fg), as_rgb_array(bg), _as_mask_array(mask)
    if native.available():
        return native.composite(fg, bg, mask)
    out = PIL.Image.composite(
        PIL.Image.fromarray(fg), PIL.Image.fromarray(bg),
        PIL.Image.fromarray(mask))
    return np.asarray(out)


def _mask_bbox(mask: np.ndarray):
    """(x0, y0, x1, y1) bounding box of nonzero mask pixels, or None."""
    rows = np.flatnonzero(mask.any(axis=1))
    if rows.size == 0:
        return None
    cols = np.flatnonzero(mask.any(axis=0))
    return cols[0], rows[0], cols[-1] + 1, rows[-1] + 1


def augment_clothing(img, mask, texture) -> np.ndarray:
    """Composite a clothing texture, modulated by image darkness
    (reference: src/margipose/data/mpi_inf_3dhp/__init__.py:101-110).

    Hot loader path: outside the mask the composite returns ``img``
    unchanged, so the blend is computed only inside the mask's bounding box
    (same result up to float32 rounding of the blend, ~10x less arithmetic
    for typical person masks)
    and in float32. The reference assumes texture assets match the frame
    size; smaller textures (e.g. the procedural stand-ins) are tiled."""
    img = as_rgb_array(img)
    mask = _as_mask_array(mask)
    bbox = _mask_bbox(mask)
    if bbox is None:  # empty mask: nothing to composite
        return img
    x0, y0, x1, y1 = bbox
    a = img[y0:y1, x0:x1].astype(np.float32)
    grey = a.mean(axis=-1)
    blackness = np.clip(255.0 - grey, 0, None) / np.float32(255.0)
    tex = np.asarray(texture, dtype=np.float32)
    h, w = img.shape[:2]
    if tex.shape[:2] != (h, w):
        reps = (-(-h // tex.shape[0]), -(-w // tex.shape[1]), 1)
        tex = np.tile(tex, reps)[:h, :w]
    tex = tex[y0:y1, x0:x1]
    tex = tex - blackness[..., np.newaxis] * tex
    tex_u8 = np.round(tex).astype(np.uint8)
    out = img.copy()
    out[y0:y1, x0:x1] = _composite(tex_u8, img[y0:y1, x0:x1], mask[y0:y1, x0:x1])
    return out


_BG_CACHE: dict = {}


def _background_array(file) -> np.ndarray:
    """Decoded (and >=768px) background as an HWC uint8 array, cached —
    there are only ~16 backgrounds but each would otherwise be decoded and
    resized for 60% of training examples."""
    bg = _BG_CACHE.get(file)
    if bg is None:
        img = PIL.Image.open(file).convert('RGB')
        w, h = img.size
        if w < 768 or h < 768:
            img = img.resize((max(w, 768), max(h, 768)))
        bg = np.asarray(img)
        _BG_CACHE[file] = bg
    return bg


def random_background(rng: np.random.RandomState):
    files = _resource_files('backgrounds', 'backgrounds/*.jpg')
    if not files:
        return None
    bg = _background_array(files[rng.randint(0, len(files))])
    # random 768x768 crop + random hflip
    h, w = bg.shape[:2]
    x = rng.randint(0, w - 768 + 1)
    y = rng.randint(0, h - 768 + 1)
    bg = bg[y:y + 768, x:x + 768]
    if rng.uniform() < 0.5:
        bg = bg[:, ::-1]
    return bg


def augment_background(img, mask, bg) -> np.ndarray:
    return _composite(img, bg, mask)


class MpiInf3dDataset(PoseDataset):
    preserve_root_joint_at_univ_scale = False
    raw_size = (768, 768)  # preprocessed frame size (SURVEY §3.5)

    def __init__(self, data_dir, data_specs=None, use_aug=False, disable_mask_aug=False,
                 seed=None):
        if data_specs is None:
            data_specs = DataSpecs(
                ImageSpecs(224, mean=ImageSpecs.IMAGENET_MEAN,
                           stddev=ImageSpecs.IMAGENET_STDDEV),
                JointsSpecs(MpiInf3dhpSkeletonDesc, n_dims=3),
            )
        super().__init__(data_specs)

        if not path.isdir(data_dir):
            raise NotADirectoryError(data_dir)

        import h5py

        metadata_files = sorted(iglob(path.join(data_dir, 'S*', 'Seq*', 'metadata.h5')))
        frame_refs = []
        univ_scale_factors = {}

        for metadata_file in metadata_files:
            match = re.match(r'.*S(\d+)/Seq(\d+)/metadata.h5', metadata_file)
            subject_id = int(match.group(1))
            sequence_id = int(match.group(2))

            activity_ids = None
            mat_annot_file = path.join(path.dirname(metadata_file), 'annot_data.mat')
            if path.isfile(mat_annot_file):
                with h5py.File(mat_annot_file, 'r') as f:
                    activity_ids = f['activity_annotation'][:].flatten().astype(int)

            with h5py.File(metadata_file, 'r') as f:
                for key in f['interesting_frames'].keys():
                    camera_id = int(re.match(r'camera(\d+)', key).group(1))
                    for frame_index in f['interesting_frames'][key]:
                        activity_id = (
                            activity_ids[frame_index] if activity_ids is not None else None
                        )
                        frame_refs.append(
                            FrameRef(subject_id, sequence_id, camera_id,
                                     int(frame_index), activity_id)
                        )
                univ_scale_factors[(subject_id, sequence_id)] = float(f['scale'][0])

        self.data_dir = data_dir
        self.use_aug = use_aug
        self.disable_mask_aug = disable_mask_aug
        self.frame_refs = frame_refs
        self.univ_scale_factors = univ_scale_factors
        self.without_image = False
        self.multicrop = False
        self._init_example_rng(seed)
        self._calibration_cache: dict = {}

    def _camera_calibration(self, camera_file):
        """Parsed camera.calibration, cached per sequence — the loader hits
        this once per sample and the text parse is measurable at full
        augmentation rates (consumers clone() intrinsics before mutating)."""
        cal = self._calibration_cache.get(camera_file)
        if cal is None:
            with open(path.join(self.data_dir, camera_file), 'r') as f:
                cal = parse_camera_calibration(f)
            self._calibration_cache[camera_file] = cal
        return cal

    @staticmethod
    def _mpi_inf_3dhp_to_canonical_skeleton(skel):
        assert skel.shape[-2] == MpiInf3dhpSkeletonDesc.n_joints
        return np.take(skel, MPI3D_TO_CANONICAL, axis=-2)

    def to_canonical_skeleton(self, skel):
        if self.skeleton_desc.canonical:
            return skel
        return self._mpi_inf_3dhp_to_canonical_skeleton(np.asarray(skel))

    def _get_skeleton_3d(self, index):
        import h5py

        frame_ref = self.frame_refs[index]
        metadata_file = path.join(self.data_dir, frame_ref.metadata_file)
        with h5py.File(metadata_file, 'r') as f:
            original_skel = np.asarray(
                f['joints3d'][frame_ref.camera_id, frame_ref.frame_index],
                dtype=np.float64,
            )

        if original_skel.shape[-2] == MpiInf3dhpSkeletonDesc.n_joints:
            skel_desc = MpiInf3dhpSkeletonDesc
        elif original_skel.shape[-2] == CanonicalSkeletonDesc.n_joints:
            skel_desc = CanonicalSkeletonDesc
        else:
            raise ValueError(f'unexpected number of joints: {original_skel.shape[-2]}')

        if self.skeleton_desc.canonical and skel_desc == MpiInf3dhpSkeletonDesc:
            original_skel = self._mpi_inf_3dhp_to_canonical_skeleton(original_skel)
            skel_desc = CanonicalSkeletonDesc
        return original_skel, skel_desc

    def _to_univ_scale(self, skel_3d, skel_desc, univ_scale_factor):
        """(reference: src/margipose/data/mpi_inf_3dhp/__init__.py:223-239)"""
        univ = np.array(skel_3d, dtype=np.float64)
        if self.preserve_root_joint_at_univ_scale:
            root = skel_3d[..., skel_desc.root_joint_id:skel_desc.root_joint_id + 1, :]
            univ = (univ - root) / univ_scale_factor + root
        else:
            univ = univ / univ_scale_factor
        return univ

    def _evaluate_3d(self, index, original_skel, norm_pred, camera_intrinsics,
                     transform_opts):
        assert self.skeleton_desc.canonical, 'can only evaluate canonical skeletons'
        expected, actual = prepare_for_3d_evaluation(
            original_skel, norm_pred, self, camera_intrinsics, transform_opts,
            known_depth=False,
        )
        included_joints = [
            CanonicalSkeletonDesc.joint_names.index(n) for n in VNect_Common_Skeleton
        ]
        return gather_3d_metrics(expected, actual, included_joints)

    def __len__(self):
        return len(self.frame_refs)

    def _build_sample(self, index, orig_camera, orig_image, orig_skel, transform_opts,
                      extrinsics):
        frame_ref = self.frame_refs[index]
        out_width = self.data_specs.input_specs.width
        out_height = self.data_specs.input_specs.height

        ctx = self.create_transformer_context(transform_opts)
        use_device_aug = self.device_aug and not self.multicrop
        host_image = None if use_device_aug else orig_image
        camera_int, img, joints3d = ctx.transform(orig_camera, host_image, orig_skel)

        z_ref = joints3d[self.skeleton_desc.root_joint_id, 2]
        target = self.skeleton_normaliser.normalise_skeleton(
            joints3d, z_ref, camera_int, out_height, out_width)

        sample = {
            'frame_ref': frame_ref.to_dict(),
            'index': index,
            'valid_depth': 1,
            'original_skel': ensure_homogeneous(orig_skel, d=3),
            'camera_intrinsic': camera_int,
            'camera_extrinsic': extrinsics,
            'target': target.astype(np.float32),
            'transform_opts': transform_opts,
            'joint_mask': np.ones(target.shape[-2], dtype=np.float32),
        }
        if use_device_aug and orig_image is not None:
            sample.update(self.device_aug_fields(ctx, orig_image))
        elif img is not None:
            sample['input'] = self.input_to_tensor(img)
        return sample

    def __getitem__(self, index):
        frame_ref = self.frame_refs[index]
        rng = self.example_rng(index)  # worker-count-invariant (base.py)

        skel_3d, skel_desc = self._get_skeleton_3d(index)
        univ_scale_factor = self.univ_scale_factors[
            (frame_ref.subject_id, frame_ref.sequence_id)]
        orig_skel = self._to_univ_scale(skel_3d, skel_desc, univ_scale_factor)

        if self.without_image:
            orig_image = None
            img_w = img_h = 768
        else:
            orig_image = PIL.Image.open(path.join(self.data_dir, frame_ref.image_file))
            img_w, img_h = orig_image.size

        cam_cal = self._camera_calibration(frame_ref.camera_file)[frame_ref.camera_id]

        # Correct for video frames stored at a lower resolution.
        orig_camera = cam_cal['intrinsics'].clone()
        orig_camera.scale_image(img_w / cam_cal['image_width'],
                                img_h / cam_cal['image_height'])
        extrinsics = cam_cal['extrinsics']

        # Bounding box = 1.5x the maximal projected joint extent
        skel_2d = orig_camera.project_cartesian(skel_3d)
        min_x, max_x = skel_2d[:, 0].min(), skel_2d[:, 0].max()
        min_y, max_y = skel_2d[:, 1].min(), skel_2d[:, 1].max()
        bb_cx = (min_x + max_x) / 2
        bb_cy = (min_y + max_y) / 2
        bb_size = 1.5 * max(max_x - min_x, max_y - min_y)

        img_short_side = min(img_h, img_w)
        out_width = self.data_specs.input_specs.width
        out_height = self.data_specs.input_specs.height

        def opts(centre_x, centre_y, rotation, scale, hflip, colour=None):
            colour = colour or {}
            return {
                'in_camera': orig_camera, 'in_width': img_w, 'in_height': img_h,
                'centre_x': centre_x, 'centre_y': centre_y,
                'rotation': rotation, 'scale': scale,
                'hflip_indices': self.skeleton_desc.hflip_indices, 'hflip': hflip,
                'out_width': out_width, 'out_height': out_height,
                'brightness': colour.get('brightness', 1),
                'contrast': colour.get('contrast', 1),
                'saturation': colour.get('saturation', 1),
                'hue': colour.get('hue', 0),
            }

        if self.multicrop:
            # 2 flips x 5 crop offsets (reference: __init__.py:332-360)
            samples = []
            for aug_hflip in [False, True]:
                for offset in [(0, 0), (-1, 0), (0, -1), (1, 0), (0, 1)]:
                    transform_opts = opts(
                        bb_cx + offset[0] * 8, bb_cy + offset[1] * 8, 0,
                        bb_size / img_short_side, aug_hflip,
                    )
                    samples.append(self._build_sample(
                        index, orig_camera, orig_image, orig_skel, transform_opts,
                        extrinsics))
            return collate(samples)

        aug_bg = aug_ub = aug_lb = False
        aug_hflip = False
        colour = {}
        aug_x = aug_y = 0.0
        aug_scale = 1.0
        aug_rot = 0

        if self.use_aug:
            # (reference: __init__.py:370-388)
            if not self.disable_mask_aug:
                aug_bg = frame_ref.bg_augmentable and rng.uniform() < 0.6
                aug_ub = frame_ref.ub_augmentable and rng.uniform() < 0.2
                aug_lb = frame_ref.lb_augmentable and rng.uniform() < 0.5
            aug_hflip = rng.uniform() < 0.5
            if rng.uniform() < 0.3:
                colour['brightness'] = rng.uniform(0.8, 1.2)
            if rng.uniform() < 0.3:
                colour['contrast'] = rng.uniform(0.8, 1.2)
            if rng.uniform() < 0.3:
                colour['saturation'] = rng.uniform(0.8, 1.2)
            if rng.uniform() < 0.3:
                colour['hue'] = rng.uniform(-0.1, 0.1)
            aug_x = rng.uniform(-16, 16)
            aug_y = rng.uniform(-16, 16)
            aug_scale = rng.uniform(0.9, 1.1)
            if rng.uniform() < 0.4:
                aug_rot = float(np.clip(rng.normal(0, 30), -30, 30))

        if orig_image is not None:
            if aug_bg:
                bg = random_background(rng)
                if bg is not None:
                    orig_image = augment_background(
                        orig_image,
                        PIL.Image.open(path.join(self.data_dir, frame_ref.bg_mask_file)),
                        bg)
            if aug_ub:
                tex = random_texture(rng)
                if tex is not None:
                    orig_image = augment_clothing(
                        orig_image,
                        PIL.Image.open(path.join(self.data_dir, frame_ref.ub_mask_file)),
                        tex)
            if aug_lb:
                tex = random_texture(rng)
                if tex is not None:
                    orig_image = augment_clothing(
                        orig_image,
                        PIL.Image.open(path.join(self.data_dir, frame_ref.lb_mask_file)),
                        tex)

        transform_opts = opts(
            bb_cx + aug_x, bb_cy + aug_y, aug_rot,
            bb_size * aug_scale / img_short_side, aug_hflip, colour,
        )
        return self._build_sample(index, orig_camera, orig_image, orig_skel,
                                  transform_opts, extrinsics)
