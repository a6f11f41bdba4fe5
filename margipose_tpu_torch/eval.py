"""Evaluation metrics and the 3D-evaluation preparation path.

(reference: src/margipose/eval.py:9-89). Host-side numpy float64 — these run
per example on untransformed, metric-space skeletons.
"""

from __future__ import annotations

import numpy as np

from margipose_tpu_torch.geometry.coords import ensure_cartesian
from margipose_tpu_torch.geometry.skeleton import (
    CanonicalSkeletonDesc,
    absolute_to_root_relative,
    apply_rigid_alignment,
)


def euclidean_distances(actual: np.ndarray, expected: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((np.asarray(actual) - np.asarray(expected)) ** 2, axis=-1))


def _included_distances(actual, expected, included_joints):
    dists = euclidean_distances(actual, expected)
    if included_joints is not None:
        dists = dists[..., included_joints]
    return dists


def mpjpe(actual, expected, included_joints=None) -> float:
    """Mean per-joint position error (reference: src/margipose/eval.py:9-13)."""
    return float(_included_distances(actual, expected, included_joints).mean())


def pck(actual, expected, included_joints=None, threshold=150) -> float:
    """Percentage of correct keypoints @150mm (reference: src/margipose/eval.py:16-20)."""
    dists = _included_distances(actual, expected, included_joints)
    return float((dists < threshold).mean())


def auc(actual, expected, included_joints=None) -> float:
    """Mean PCK over 31 thresholds 0-150mm, mimicking mpii_compute_3d_pck.m
    (reference: src/margipose/eval.py:23-31)."""
    dists = _included_distances(actual, expected, included_joints)
    return _auc_from_distances(dists)


def _auc_from_distances(dists) -> float:
    thresholds = np.linspace(0, 150, 31)
    return float(
        (dists.reshape(-1)[None, :] < thresholds[:, None]).mean())


def expected_3d_skeleton(original_skel, dataset):
    """Ground truth in evaluation space: canonical joints, root-relative
    (the ``expected`` half of ``prepare_for_3d_evaluation``; shared with the
    GUI's ground-truth-only 3D view so the two can never diverge)."""
    return absolute_to_root_relative(
        dataset.to_canonical_skeleton(
            ensure_cartesian(np.asarray(original_skel, np.float64), d=3)),
        CanonicalSkeletonDesc.root_joint_id,
    )


def prepare_for_3d_evaluation(original_skel, norm_pred, dataset, camera_intrinsics,
                              transform_opts, known_depth=False):
    """Process predictions and ground truth into root-relative original
    skeleton space (reference: src/margipose/eval.py:34-67).

    Returns (expected, actual) skeletons as [J, 3] numpy arrays.
    """
    if known_depth:
        z_ref = float(np.asarray(original_skel)[dataset.skeleton_desc.root_joint_id][2])
        denorm_skel = dataset.denormalise_with_depth(norm_pred, z_ref, camera_intrinsics)
    else:
        denorm_skel = dataset.denormalise_with_skeleton_height(
            norm_pred, camera_intrinsics, transform_opts
        )
    pred_skel = dataset.untransform_skeleton(denorm_skel, transform_opts)
    actual = absolute_to_root_relative(
        dataset.to_canonical_skeleton(ensure_cartesian(pred_skel, d=3)),
        CanonicalSkeletonDesc.root_joint_id,
    )
    expected = expected_3d_skeleton(original_skel, dataset)
    return expected, actual


def gather_3d_metrics(expected, actual, included_joints=None) -> dict:
    """All six metrics incl. Procrustes-aligned variants
    (reference: src/margipose/eval.py:70-85)."""
    aligned = apply_rigid_alignment(actual, expected)
    # each variant's distances computed ONCE and shared by mpjpe/pck/auc —
    # this runs per example (and per crop) in the host-side eval loop
    dists = _included_distances(actual, expected, included_joints)
    adists = _included_distances(aligned, expected, included_joints)
    return dict(
        mpjpe=float(dists.mean()),
        pck=float((dists < 150).mean()),
        auc=_auc_from_distances(dists),
        aligned_mpjpe=float(adists.mean()),
        aligned_pck=float((adists < 150).mean()),
        aligned_auc=_auc_from_distances(adists),
    )


def calculate_pckh_distance(pred, target, head_length):
    return float(np.linalg.norm(np.asarray(target) - np.asarray(pred)) / head_length)
