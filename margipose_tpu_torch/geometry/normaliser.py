"""Skeleton normalisation between camera space (mm) and model space [-1, 1]^3.

Reimplements the ``pose3d_utils.skeleton_normaliser.SkeletonNormaliser``
capability surface used by the reference (call sites:
src/margipose/data/mpi_inf_3dhp/__init__.py:264-265,
src/margipose/data/__init__.py:52-95).

Convention (margipose_tpu):
  * x_n, y_n are the perspective-projected pixel coordinates of the joint in
    the (transformed) image, mapped linearly from [0, W] x [0, H] to [-1, 1]^2.
  * z_n = (Z - z_ref) / k where ``k`` is the metric length corresponding to
    one normalized x/y unit at depth ``z_ref``:
        k = z_ref * sqrt((W/2) * (H/2) / |det K2|)
    with K2 the upper-left 2x2 of the intrinsic matrix. This makes the
    normalized cube isotropic at the reference depth, which is what the
    marginal-heatmap geometry requires (zy/xz heatmaps share axes with y/x).

``normalise_skeleton`` and ``denormalise_skeleton`` are exact inverses for a
fixed ``z_ref``. Because every denormalised coordinate scales linearly with
``z_ref`` (root depth), ``infer_depth`` converges via fixed-point iteration
(exactly one step when the eval-scale functional is scale-reciprocal, as both
reference functionals are).
"""

from __future__ import annotations

import numpy as np

from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.coords import ensure_homogeneous


class SkeletonNormaliser:
    @staticmethod
    def depth_scale(z_ref: float, intrinsics: CameraIntrinsics, height, width) -> float:
        det = abs(np.linalg.det(intrinsics.matrix[:2, :2]))
        return float(z_ref) * float(np.sqrt((width / 2.0) * (height / 2.0) / det))

    def normalise_skeleton(self, denormalised, z_ref, intrinsics: CameraIntrinsics,
                           height, width) -> np.ndarray:
        """Camera-space homogeneous skeleton [J, 4] -> normalized [J, 4]."""
        hom = ensure_homogeneous(np.asarray(denormalised, dtype=np.float64), d=3)
        z_ref = float(z_ref)
        proj = intrinsics.project_cartesian(hom)
        x_n = (proj[..., 0] - width / 2.0) / (width / 2.0)
        y_n = (proj[..., 1] - height / 2.0) / (height / 2.0)
        k = self.depth_scale(z_ref, intrinsics, height, width)
        z_n = (hom[..., 2] / hom[..., 3] - z_ref) / k
        w = np.ones_like(x_n)
        return np.stack([x_n, y_n, z_n, w], axis=-1)

    def denormalise_skeleton(self, normalised, z_ref, intrinsics: CameraIntrinsics,
                             height, width) -> np.ndarray:
        """Normalized homogeneous skeleton [J, 4] -> camera-space [J, 4] (mm)."""
        norm = ensure_homogeneous(np.asarray(normalised, dtype=np.float64), d=3)
        norm = norm[..., :3] / norm[..., 3:]
        z_ref = float(z_ref)
        k = self.depth_scale(z_ref, intrinsics, height, width)
        depths = norm[..., 2] * k + z_ref
        u = (norm[..., 0] + 1.0) * (width / 2.0)
        v = (norm[..., 1] + 1.0) * (height / 2.0)
        pixels = np.stack([u, v], axis=-1)
        cart = intrinsics.back_project(pixels, depths)
        return ensure_homogeneous(cart, d=3)

    def infer_depth(self, normalised_skel, eval_scale, intrinsics: CameraIntrinsics,
                    height, width, z_init: float = 1000.0, n_iters: int = 4) -> float:
        """Find z_ref such that the denormalised skeleton has the correct
        physical size (eval_scale(denorm(skel, z_ref)) == 1).

        The denormalised skeleton scales linearly in z_ref under this
        normalisation convention, so the fixed-point update
        ``z <- z * eval_scale(denorm(norm, z))`` converges in one step for
        reference eval-scale functionals; extra iterations guard against
        mildly nonlinear functionals.
        """
        z = float(z_init)
        for _ in range(n_iters):
            skel = self.denormalise_skeleton(normalised_skel, z, intrinsics, height, width)
            scale = float(eval_scale(skel))
            if scale <= 0 or not np.isfinite(scale):
                # degenerate prediction (eg. collapsed bones) — surface it
                # rather than silently evaluating at the current depth
                import warnings

                warnings.warn(
                    f'infer_depth: eval_scale returned {scale!r}; '
                    f'falling back to z_ref={z:.1f}mm', RuntimeWarning)
                break
            new_z = z * scale
            if abs(new_z - z) < 1e-9 * max(1.0, abs(z)):
                z = new_z
                break
            z = new_z
        return z
