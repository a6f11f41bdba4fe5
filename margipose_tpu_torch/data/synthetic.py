"""Procedural synthetic pose dataset.

Renders a stick-figure person (derived from a template canonical skeleton)
with a pinhole camera into an RGB image. Provides the full ``PoseDataset``
surface — transforms, normalisation, 3D evaluation — so the end-to-end
train/eval/infer paths run (and are tested) without the real MPI-INF-3DHP /
H36M / MPII data present. Not part of the reference; a copy of the JAX
package's addition for hermetic testing and benchmarking.
"""

from __future__ import annotations

import numpy as np
import PIL.Image
import PIL.ImageDraw

from margipose_tpu_torch.data.base import PoseDataset, collate
from margipose_tpu_torch.data.specs import DataSpecs, ImageSpecs, JointsSpecs
from margipose_tpu_torch.eval import gather_3d_metrics, prepare_for_3d_evaluation
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc

# Template: a real canonical-skeleton pose at universal scale (mm), with the
# pelvis moved to the origin.
_TEMPLATE = np.array([
    [ -14.1671, -334.8410, 3685.4099],
    [  -1.8908,  -78.7086, 3697.4800],
    [  12.3105,   -6.8914, 3570.3000],
    [  28.6693,   53.3262, 3259.5300],
    [  65.5078,   80.3900, 3018.8301],
    [ -21.9359,    6.5647, 3823.5701],
    [ -48.9321,    9.3914, 4139.3799],
    [ -48.1227,   29.9672, 4383.5200],
    [  26.1703,  404.6510, 3596.6575],
    [ -15.4026,  957.8070, 3670.3301],
    [ -87.2411, 1390.7700, 3718.3999],
    [ -22.8190,  401.2070, 3829.8625],
    [ -45.7490,  956.8290, 3800.5901],
    [-137.3620, 1388.2400, 3780.2000],
    [   1.6757,  402.9290, 3713.2600],
    [ -11.7886,  176.2583, 3705.0913],
    [  11.9904, -164.0930, 3696.2600],
], dtype=np.float64)
_TEMPLATE = _TEMPLATE - _TEMPLATE[CanonicalSkeletonDesc.root_joint_id]


def _rotation_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


class SyntheticPoseDataset(PoseDataset):
    def __init__(self, data_specs=None, length=256, use_aug=False, seed=0,
                 image_size=512):
        if data_specs is None:
            data_specs = DataSpecs(
                ImageSpecs(256, mean=ImageSpecs.IMAGENET_MEAN,
                           stddev=ImageSpecs.IMAGENET_STDDEV),
                JointsSpecs(CanonicalSkeletonDesc, n_dims=3),
            )
        super().__init__(data_specs)
        self.length = length
        self.use_aug = use_aug
        self.seed = seed
        self.image_size = image_size
        self.raw_size = (image_size, image_size)
        self.without_image = False
        self.multicrop = False

    def to_canonical_skeleton(self, skel):
        return skel

    def _example_geometry(self, index):
        """Deterministic per-index world state."""
        rng = np.random.RandomState(self.seed * 100003 + index)
        rot = _rotation_y(rng.uniform(-np.pi, np.pi))
        scale = rng.uniform(0.9, 1.1)
        skel = (_TEMPLATE * scale) @ rot.T
        centre = np.array([
            rng.uniform(-300, 300), rng.uniform(-200, 200), rng.uniform(2800, 4500)
        ])
        skel = skel + centre
        w = h = self.image_size
        f = rng.uniform(1.8, 2.2) * w
        camera = CameraIntrinsics.from_ccd_params(f, f, w / 2, h / 2)
        return skel, camera, rng

    def _render(self, skel, camera, rng):
        w = h = self.image_size
        img = PIL.Image.fromarray(
            (rng.rand(h // 8, w // 8, 3) * 80 + 40).astype(np.uint8)
        ).resize((w, h))
        draw = PIL.ImageDraw.Draw(img)
        pix = camera.project_cartesian(skel)
        tree = CanonicalSkeletonDesc.joint_tree
        # Bone colours vary with joint index so left/right are distinguishable
        for j, parent in enumerate(tree):
            if j == parent:
                continue
            colour = (40 + j * 12, 220 - j * 10, 60 + j * 9)
            draw.line(
                [tuple(pix[j]), tuple(pix[parent])],
                fill=colour, width=max(2, w // 90),
            )
        head = pix[CanonicalSkeletonDesc.joint_names.index('head')]
        r = w // 40
        draw.ellipse([head[0] - r, head[1] - r, head[0] + r, head[1] + r],
                     fill=(240, 200, 160))
        return img

    def _evaluate_3d(self, index, original_skel, norm_pred, camera_intrinsics,
                     transform_opts):
        expected, actual = prepare_for_3d_evaluation(
            original_skel, norm_pred, self, camera_intrinsics, transform_opts,
            known_depth=False,
        )
        return gather_3d_metrics(expected, actual)

    def __len__(self):
        return self.length

    def _build_sample(self, index, orig_camera, orig_image, orig_skel, transform_opts):
        out_w = self.data_specs.input_specs.width
        out_h = self.data_specs.input_specs.height
        ctx = self.create_transformer_context(transform_opts)
        camera_int, img, joints3d = ctx.transform(orig_camera, orig_image, orig_skel)
        z_ref = joints3d[self.skeleton_desc.root_joint_id, 2]
        target = self.skeleton_normaliser.normalise_skeleton(
            joints3d, z_ref, camera_int, out_h, out_w)
        sample = {
            'index': index,
            'valid_depth': 1,
            'original_skel': ensure_homogeneous(orig_skel, d=3),
            'camera_intrinsic': camera_int,
            'camera_extrinsic': np.eye(4),
            'target': target.astype(np.float32),
            'transform_opts': transform_opts,
            'joint_mask': np.ones(target.shape[-2], dtype=np.float32),
        }
        if img is not None:
            sample['input'] = self.input_to_tensor(img)
        return sample

    def __getitem__(self, index):
        skel, camera, rng = self._example_geometry(index)
        orig_image = None if self.without_image else self._render(skel, camera, rng)

        pix = camera.project_cartesian(skel)
        min_x, max_x = pix[:, 0].min(), pix[:, 0].max()
        min_y, max_y = pix[:, 1].min(), pix[:, 1].max()
        bb_cx = (min_x + max_x) / 2
        bb_cy = (min_y + max_y) / 2
        bb_size = 1.5 * max(max_x - min_x, max_y - min_y)

        def opts(cx, cy, rotation, scale, hflip, colour=None):
            colour = colour or {}
            return {
                'in_camera': camera,
                'in_width': self.image_size, 'in_height': self.image_size,
                'centre_x': cx, 'centre_y': cy, 'rotation': rotation, 'scale': scale,
                'hflip_indices': self.skeleton_desc.hflip_indices, 'hflip': hflip,
                'out_width': self.data_specs.input_specs.width,
                'out_height': self.data_specs.input_specs.height,
                'brightness': colour.get('brightness', 1),
                'contrast': colour.get('contrast', 1),
                'saturation': colour.get('saturation', 1),
                'hue': colour.get('hue', 0),
            }

        if self.multicrop:
            samples = []
            for aug_hflip in [False, True]:
                for offset in [(0, 0), (-1, 0), (0, -1), (1, 0), (0, 1)]:
                    transform_opts = opts(bb_cx + offset[0] * 8, bb_cy + offset[1] * 8,
                                          0, bb_size / self.image_size, aug_hflip)
                    samples.append(self._build_sample(
                        index, camera, orig_image, skel, transform_opts))
            return collate(samples)

        aug_hflip = False
        colour = {}
        aug_x = aug_y = 0.0
        aug_scale = 1.0
        aug_rot = 0
        if self.use_aug:
            aug_hflip = rng.rand() < 0.5
            if rng.rand() < 0.3:
                colour['brightness'] = rng.uniform(0.8, 1.2)
            if rng.rand() < 0.3:
                colour['contrast'] = rng.uniform(0.8, 1.2)
            if rng.rand() < 0.3:
                colour['saturation'] = rng.uniform(0.8, 1.2)
            if rng.rand() < 0.3:
                colour['hue'] = rng.uniform(-0.1, 0.1)
            aug_x = rng.uniform(-16, 16)
            aug_y = rng.uniform(-16, 16)
            aug_scale = rng.uniform(0.9, 1.1)
            if rng.rand() < 0.4:
                aug_rot = float(np.clip(rng.normal(0, 30), -30, 30))

        transform_opts = opts(bb_cx + aug_x, bb_cy + aug_y, aug_rot,
                              bb_size * aug_scale / self.image_size, aug_hflip, colour)
        return self._build_sample(index, camera, orig_image, skel, transform_opts)
