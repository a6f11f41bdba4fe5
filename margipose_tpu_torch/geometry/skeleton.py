"""Skeleton descriptions and joint-coordinate math (host-side, numpy float64).

Functional re-design of the reference ``margipose/data/skeleton.py``
(reference: src/margipose/data/skeleton.py:9-260). Operates on numpy arrays;
these run in the per-example data/eval paths, not on-device.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import procrustes

from margipose_tpu_torch.geometry.coords import (
    ensure_cartesian,
    ensure_homogeneous,
    homogeneous_to_cartesian,
)

# 14-joint skeleton used in the VNect paper for some evaluation
# (reference: src/margipose/data/skeleton.py:9-16)
VNect_Common_Skeleton = [
    'head_top', 'neck', 'right_shoulder', 'right_elbow', 'right_wrist',
    'left_shoulder', 'left_elbow', 'left_wrist', 'right_hip', 'right_knee',
    'right_ankle', 'left_hip', 'left_knee', 'left_ankle',
]


class SkeletonDesc:
    def __init__(self, joint_names, joint_tree, hflip_indices):
        self.joint_names = list(joint_names)
        self.joint_tree = list(joint_tree)
        self.hflip_indices = list(hflip_indices)

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def canonical(self) -> bool:
        return (
            self.n_joints == CanonicalSkeletonDesc.n_joints
            and self.joint_names == CanonicalSkeletonDesc.joint_names
        )

    @property
    def root_joint_id(self) -> int:
        return self.joint_names.index('pelvis')

    def to_dict(self) -> dict:
        return {
            'joint_names': self.joint_names,
            'joint_tree': self.joint_tree,
            'hflip_indices': self.hflip_indices,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SkeletonDesc":
        return cls(d['joint_names'], d['joint_tree'], d['hflip_indices'])


# (reference: src/margipose/data/skeleton.py:51-74)
CanonicalSkeletonDesc = SkeletonDesc(
    joint_names=[
        'head_top', 'neck', 'right_shoulder', 'right_elbow', 'right_wrist',
        'left_shoulder', 'left_elbow', 'left_wrist', 'right_hip', 'right_knee',
        'right_ankle', 'left_hip', 'left_knee', 'left_ankle', 'pelvis',
        'spine', 'head',
    ],
    joint_tree=[
        1, 15, 1, 2, 3,
        1, 5, 6, 14, 8,
        9, 14, 11, 12, 14,
        14, 1,
    ],
    hflip_indices=[
        0, 1, 5, 6, 7,
        2, 3, 4, 11, 12,
        13, 8, 9, 10, 14,
        15, 16,
    ],
)


def absolute_to_parent_relative(joints: np.ndarray, joint_tree) -> np.ndarray:
    parents = np.take(joints, joint_tree, axis=-2)
    return joints - parents


def parent_relative_to_absolute(relative: np.ndarray, joint_tree) -> np.ndarray:
    absolute = np.zeros_like(relative)
    for j, parent in enumerate(joint_tree):
        a, b = j, parent
        while a != b:
            absolute[..., j, :] += relative[..., a, :]
            a, b = b, joint_tree[b]
    return absolute


def absolute_to_root_relative(joints: np.ndarray, root_index: int) -> np.ndarray:
    root = joints[..., root_index : root_index + 1, :]
    return joints - root


def cartesian_to_spherical(cartesian: np.ndarray) -> np.ndarray:
    x, y, z = cartesian[..., 0], cartesian[..., 1], cartesian[..., 2]
    r = np.sqrt(np.sum(cartesian**2, axis=-1))
    with np.errstate(divide='ignore', invalid='ignore'):
        theta = np.arccos(np.where(r > 0, z / np.where(r > 0, r, 1.0), 1.0))
    phi = np.arctan2(y, x)
    return np.stack([r, theta, phi], axis=-1)


def spherical_to_cartesian(spherical: np.ndarray) -> np.ndarray:
    r, theta, phi = spherical[..., 0], spherical[..., 1], spherical[..., 2]
    sin_theta = np.sin(theta)
    x = r * sin_theta * np.cos(phi)
    y = r * sin_theta * np.sin(phi)
    z = r * np.cos(theta)
    return np.stack([x, y, z], axis=-1)


def torch_median(values) -> float:
    """Median with torch.median semantics: for an even count, the LOWER of
    the two middle values — not numpy's average of them. Everywhere the
    reference takes `tensor.median()` over a derived ratio this is the
    convention, and the parity tests showed it matters at full float64
    precision (tests/test_reference_parity.py)."""
    values = np.asarray(values).ravel()
    return float(np.sort(values)[(values.size - 1) // 2])


def calc_relative_scale(skeleton, ref_bone_lengths, joint_tree) -> float:
    """Median factor by which the reference is larger than the query skeleton
    (reference: src/margipose/data/skeleton.py:115-135)."""
    bone_lengths = cartesian_to_spherical(
        absolute_to_parent_relative(ensure_cartesian(skeleton, d=3), joint_tree)
    )[:, 0]
    non_zero = bone_lengths > 1e-6
    if non_zero.sum() == 0:
        return 0.0
    ratio = np.asarray(ref_bone_lengths)[non_zero] / bone_lengths[non_zero]
    # The count here is even in practice (the pelvis self-loop bone is
    # masked out of the 17-joint tree), so torch's lower-middle median is
    # parity-critical; caught by directly executing the reference's
    # calc_relative_scale in tests/test_reference_parity.py.
    return torch_median(ratio)


def bone_path_length(sph_rel_joints, joint_a, joint_b, joint_tree):
    parent_a = joint_tree[joint_a]
    parent_b = joint_tree[joint_b]
    if parent_a != joint_a:
        return sph_rel_joints[joint_a, 0] + bone_path_length(
            sph_rel_joints, parent_a, joint_b, joint_tree
        )
    elif parent_b != joint_b:
        return sph_rel_joints[joint_b, 0] + bone_path_length(
            sph_rel_joints, joint_a, parent_b, joint_tree
        )
    return 0


def calculate_knee_neck_height(skel, joint_names) -> float:
    """Skeleton height from left knee to neck via the spine joint
    (reference: src/margipose/data/skeleton.py:152-177)."""
    left_knee = joint_names.index('left_knee')
    left_hip = joint_names.index('left_hip')
    spine = joint_names.index('spine')
    pelvis = joint_names.index('pelvis')
    neck = joint_names.index('neck')

    skel = ensure_cartesian(skel, d=3)
    return float(
        np.linalg.norm(skel[left_knee] - skel[left_hip])
        + np.linalg.norm(skel[spine] - skel[pelvis])
        + np.linalg.norm(skel[neck] - skel[spine])
    )


def apply_rigid_alignment(skel, ref_skel) -> np.ndarray:
    """Procrustes-align a skeleton to a reference
    (reference: src/margipose/data/skeleton.py:180-193)."""
    skel = np.asarray(skel, dtype=np.float64)
    ref_skel = np.asarray(ref_skel, dtype=np.float64)
    _, mtx2, _ = procrustes(ref_skel, skel)
    mean = np.mean(ref_skel, 0)
    stddev = np.linalg.norm(ref_skel - mean)
    return (mtx2 * stddev) + mean


def make_eval_scale_skeleton_height(skel_desc: SkeletonDesc, untransform):
    """Scale factor bringing knee-neck height to 920mm
    (reference: src/margipose/data/skeleton.py:196-202)."""
    target_sum = 920
    joint_names = skel_desc.joint_names

    def eval_scale(test_skel):
        skel = untransform(test_skel)
        return target_sum / (calculate_knee_neck_height(skel, joint_names) + 1e-12)

    return eval_scale


def make_eval_scale_bone_lengths(skel_desc: SkeletonDesc, untransform, ref_skel):
    """Scale factor matching median bone-length ratios against a reference
    skeleton (reference: src/margipose/data/skeleton.py:205-213)."""
    joint_tree = skel_desc.joint_tree
    ref_bone_lengths = cartesian_to_spherical(
        absolute_to_parent_relative(ensure_cartesian(ref_skel, d=3), joint_tree)
    )[:, 0]

    def eval_scale(test_skel):
        skel = untransform(test_skel)
        return calc_relative_scale(skel, ref_bone_lengths, joint_tree)

    return eval_scale


def canonicalise_orientation(skel_desc: SkeletonDesc, skel) -> np.ndarray:
    """Rotate a skeleton into canonical orientation: pelvis at origin,
    shoulder plane aligned with XY, "forwards" along -Z
    (reference: src/margipose/data/skeleton.py:216-260)."""
    skel = ensure_homogeneous(np.asarray(skel, dtype=np.float64), d=3)
    cart_skel = homogeneous_to_cartesian(skel)
    cart_skel = cart_skel - cart_skel[skel_desc.root_joint_id]
    rshoulder = cart_skel[skel_desc.joint_names.index('right_shoulder')]
    lshoulder = cart_skel[skel_desc.joint_names.index('left_shoulder')]
    pelvis = cart_skel[skel_desc.joint_names.index('pelvis')]

    v1 = rshoulder - pelvis
    v2 = lshoulder - pelvis
    forward = np.cross(v1, v2)
    forward = forward / np.linalg.norm(forward)

    up = 0.5 * (v1 + v2)
    up = up / np.linalg.norm(up)

    right = np.cross(forward, up)
    right = right / np.linalg.norm(right)

    up = np.cross(forward, right)

    look_at = np.array([
        [right[0], up[0], forward[0], 0],
        [right[1], up[1], forward[1], 0],
        [right[2], up[2], forward[2], 0],
        [0, 0, 0, 1],
    ], dtype=np.float64)

    return ensure_homogeneous(cart_skel, d=3) @ look_at
