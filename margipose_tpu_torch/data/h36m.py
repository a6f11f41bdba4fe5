"""Human3.6M dataset loader (protocol 2).

(reference: src/margipose/data/h36m/__init__.py:23-357). Reads per-sequence
``annot.h5`` files with pose/2d, pose/3d, pose/3d-univ, intrinsics, camera,
frame, subject, action, subaction datasets.
"""

from __future__ import annotations

from glob import iglob
from os import path

import numpy as np
import PIL.Image

from margipose_tpu_torch.data.base import PoseDataset, collate
from margipose_tpu_torch.data.specs import DataSpecs, ImageSpecs, JointsSpecs
from margipose_tpu_torch.eval import gather_3d_metrics, prepare_for_3d_evaluation
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc, SkeletonDesc

# (reference: src/margipose/data/h36m/__init__.py:23-62)
H36MSkeletonDesc = SkeletonDesc(
    joint_names=[
        'pelvis', 'right_hip', 'right_knee', 'right_ankle',
        'right_toes', 'right_site1', 'left_hip', 'left_knee',
        'left_ankle', 'left_toes', 'left_site1', 'spine1',
        'spine', 'neck', 'head', 'head_top',
        'left_clavicle', 'left_shoulder', 'left_elbow', 'left_wrist',
        'left_thumb', 'left_site2', 'left_wrist2', 'left_site3',
        'right_clavicle', 'right_shoulder', 'right_elbow', 'right_wrist',
        'right_thumb', 'right_site2', 'right_wrist2', 'right_site3',
    ],
    joint_tree=[
        0, 0, 1, 2,
        3, 4, 0, 6,
        7, 8, 9, 0,
        11, 12, 13, 14,
        12, 16, 17, 18,
        19, 20, 19, 22,
        12, 24, 25, 26,
        27, 28, 27, 30,
    ],
    hflip_indices=[
        0, 6, 7, 8,
        9, 10, 1, 2,
        3, 4, 5, 11,
        12, 13, 14, 15,
        24, 25, 26, 27,
        28, 29, 30, 31,
        16, 17, 18, 19,
        20, 21, 22, 23,
    ],
)

H36M_Actions = {
    1: 'Miscellaneous', 2: 'Directions', 3: 'Discussion', 4: 'Eating',
    5: 'Greeting', 6: 'Phoning', 7: 'Posing', 8: 'Purchases',
    9: 'Sitting', 10: 'SittingDown', 11: 'Smoking', 12: 'TakingPhoto',
    13: 'Waiting', 14: 'Walking', 15: 'WalkingDog', 16: 'WalkingTogether',
}

H36M_TO_CANONICAL = [
    H36MSkeletonDesc.joint_names.index(name)
    for name in CanonicalSkeletonDesc.joint_names
]


def h36m_to_canonical_skeleton(skel: np.ndarray) -> np.ndarray:
    assert skel.shape[-2] == H36MSkeletonDesc.n_joints
    return np.take(skel, H36M_TO_CANONICAL, axis=-2)


class H36MDataset(PoseDataset):
    """Protocol #2: train subjects {1,5,6,7,8}, test {9,11}."""

    def __init__(self, data_dir, data_specs=None, subset='trainval', use_aug=False,
                 max_length=None, universal=False, seed=None):
        if data_specs is None:
            data_specs = DataSpecs(
                ImageSpecs(224, mean=ImageSpecs.IMAGENET_MEAN,
                           stddev=ImageSpecs.IMAGENET_STDDEV),
                JointsSpecs(H36MSkeletonDesc, n_dims=2),
            )
        super().__init__(data_specs)

        if not path.isdir(data_dir):
            raise NotADirectoryError(data_dir)

        import h5py

        self.subset = subset
        self.use_aug = use_aug
        self.data_dir = data_dir
        self._init_example_rng(seed)

        annot_files = sorted(iglob(path.join(data_dir, 'S*', '*', 'annot.h5')))
        keys = ['pose/2d', 'pose/3d', 'pose/3d-univ', 'camera', 'frame',
                'subject', 'action', 'subaction']
        datasets = {k: [] for k in keys}
        self.camera_intrinsics = []
        intrinsics_ds = 'intrinsics-univ' if universal else 'intrinsics'

        for annot_file in annot_files:
            with h5py.File(annot_file, 'r') as annot:
                for k in keys:
                    datasets[k].append(np.asarray(annot[k]))
                cams = {}
                for camera_id in annot[intrinsics_ds].keys():
                    alpha_x, x_0, alpha_y, y_0 = list(annot[intrinsics_ds][camera_id])
                    cams[int(camera_id)] = CameraIntrinsics.from_ccd_params(
                        alpha_x, alpha_y, x_0, y_0)
                for camera_id in annot['camera']:
                    self.camera_intrinsics.append(cams[int(camera_id)])
        datasets = {k: np.concatenate(v) for k, v in datasets.items()}

        self.frame_ids = datasets['frame']
        self.subject_ids = datasets['subject']
        self.action_ids = datasets['action']
        self.subaction_ids = datasets['subaction']
        self.camera_ids = datasets['camera']
        self.joint_3d = datasets['pose/3d-univ'] if universal else datasets['pose/3d']
        self.joint_2d = datasets['pose/2d']

        train_subjects = {1, 5, 6, 7, 8}
        test_subjects = {9, 11}
        train_ids, test_ids = [], []
        for index, subject_id in enumerate(self.subject_ids):
            if subject_id in train_subjects:
                train_ids.append(index)
            if subject_id in test_subjects:
                test_ids.append(index)

        if subset == 'trainval':
            self.example_ids = np.array(train_ids, np.uint32)
        elif subset == 'test':
            self.example_ids = np.array(test_ids, np.uint32)
        else:
            raise ValueError('Only trainval and test subsets are supported')

        if max_length is not None:
            self.example_ids = self.example_ids[:max_length]

        self.without_image = False
        self.multicrop = False

    def to_canonical_skeleton(self, skel):
        if self.skeleton_desc.canonical:
            return skel
        return h36m_to_canonical_skeleton(np.asarray(skel))

    def get_orig_skeleton(self, index):
        id = self.example_ids[index]
        original_skel = ensure_homogeneous(
            np.asarray(self.joint_3d[id], dtype=np.float64), d=3)
        if self.skeleton_desc.canonical:
            if original_skel.shape[-2] == H36MSkeletonDesc.n_joints:
                original_skel = h36m_to_canonical_skeleton(original_skel)
            else:
                raise ValueError(
                    f'unexpected number of joints: {original_skel.shape[-2]}')
        return original_skel

    def _load_image(self, id):
        if self.without_image:
            return None
        image_file = path.join(
            self.data_dir,
            'S{:d}'.format(int(self.subject_ids[id])),
            '{}-{:d}'.format(H36M_Actions[int(self.action_ids[id])],
                             int(self.subaction_ids[id])),
            'imageSequence',
            str(int(self.camera_ids[id])),
            'img_{:06d}.jpg'.format(int(self.frame_ids[id])),
        )
        return PIL.Image.open(image_file)

    def _evaluate_3d(self, index, original_skel, norm_pred, camera_intrinsics,
                     transform_opts):
        assert self.skeleton_desc.canonical, 'can only evaluate canonical skeletons'
        expected, actual = prepare_for_3d_evaluation(
            original_skel, norm_pred, self, camera_intrinsics, transform_opts,
            known_depth=True,
        )
        return gather_3d_metrics(expected, actual)

    def __len__(self):
        return len(self.example_ids)

    def _build_sample(self, index, orig_camera, orig_image, orig_skel, transform_opts,
                      extrinsics):
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
            'index': index,
            'valid_depth': 1,
            'original_skel': orig_skel,
            'camera_intrinsic': camera_int,
            'camera_extrinsic': extrinsics,
            'target': target.astype(np.float32),
            'transform_opts': transform_opts,
            'joint_mask': np.ones(target.shape[-2], dtype=np.float32),
        }
        if use_device_aug and orig_image is not None:
            # variable-size frames letterboxed onto the shared canvas
            sample.update(self.device_aug_fields(ctx, orig_image))
        elif img is not None:
            sample['input'] = self.input_to_tensor(img)
        return sample

    def __getitem__(self, index):
        id = self.example_ids[index]
        rng = self.example_rng(index)  # worker-count-invariant (base.py)

        orig_image = self._load_image(id)
        if orig_image is not None:
            img_w, img_h = orig_image.size
        else:
            img_w = img_h = 1000
        img_short_side = min(img_h, img_w)

        extrinsics = np.eye(4, dtype=np.float64)
        orig_camera = self.camera_intrinsics[id]
        orig_skel = self.get_orig_skeleton(index)

        joints2d = orig_camera.project_cartesian(orig_skel)
        min_x, max_x = joints2d[:, 0].min(), joints2d[:, 0].max()
        min_y, max_y = joints2d[:, 1].min(), joints2d[:, 1].max()
        bb_cx = (min_x + max_x) / 2
        bb_cy = (min_y + max_y) / 2
        bb_size = 1.5 * max(max_x - min_x, max_y - min_y)

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

        aug_hflip = False
        colour = {}
        aug_x = aug_y = 0.0
        aug_scale = 1.0
        aug_rot = 0
        if self.use_aug:
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

        transform_opts = opts(
            bb_cx + aug_x, bb_cy + aug_y, aug_rot,
            bb_size * aug_scale / img_short_side, aug_hflip, colour,
        )
        return self._build_sample(index, orig_camera, orig_image, orig_skel,
                                  transform_opts, extrinsics)
