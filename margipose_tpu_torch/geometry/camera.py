"""Pinhole camera intrinsics (host-side, numpy float64).

Reimplements the ``pose3d_utils.camera.CameraIntrinsics`` API surface used by
the reference (construction from a 3x4 matrix at
src/margipose/data/mpi_inf_3dhp/common.py:130, ``from_ccd_params`` at
src/margipose/data/h36m/__init__.py:145, ``scale_image`` at
src/margipose/data/mpi_inf_3dhp/__init__.py:311-314, projection at
src/margipose/data/mpi_inf_3dhp/__init__.py:319).

Additionally supports absorbing an arbitrary 2D image-space affine into the
intrinsic matrix (``affine_transformed``), which is how the margipose_tpu
transform pipeline models crops/rotations/flips: the intrinsics carry the
full image-space mapping while 3D points stay in the original camera space.
"""

from __future__ import annotations

import numpy as np

from margipose_tpu_torch.geometry.coords import ensure_homogeneous, homogeneous_to_cartesian


class CameraIntrinsics:
    def __init__(self, matrix=None):
        if matrix is None:
            matrix = np.eye(3, 4)
        matrix = np.asarray(matrix, dtype=np.float64)
        assert matrix.shape == (3, 4), f"expected 3x4 intrinsic matrix, got {matrix.shape}"
        self.matrix = matrix.copy()

    @classmethod
    def from_ccd_params(cls, alpha_x, alpha_y, x_0, y_0) -> "CameraIntrinsics":
        m = np.eye(3, 4)
        m[0, 0] = alpha_x
        m[1, 1] = alpha_y
        m[0, 2] = x_0
        m[1, 2] = y_0
        return cls(m)

    @property
    def alpha_x(self) -> float:
        return float(self.matrix[0, 0])

    @property
    def alpha_y(self) -> float:
        return float(self.matrix[1, 1])

    @property
    def x_0(self) -> float:
        return float(self.matrix[0, 2])

    @property
    def y_0(self) -> float:
        return float(self.matrix[1, 2])

    def clone(self) -> "CameraIntrinsics":
        return CameraIntrinsics(self.matrix)

    def scale_image(self, sx: float, sy: float) -> "CameraIntrinsics":
        """Adjust intrinsics for an image resized by (sx, sy). In-place."""
        self.matrix[0] *= sx
        self.matrix[1] *= sy
        return self

    def affine_transformed(self, affine: np.ndarray) -> "CameraIntrinsics":
        """New intrinsics for an image warped by 2D affine ``affine`` (3x3).

        Any 2D affine A on pixel coordinates can be absorbed entirely into
        the intrinsic matrix: u' = A u = (A K) X / Z. 3D points are unchanged.
        """
        affine = np.asarray(affine, dtype=np.float64)
        assert affine.shape == (3, 3)
        return CameraIntrinsics(affine @ self.matrix)

    def project(self, hom_points: np.ndarray) -> np.ndarray:
        """Project homogeneous 3D points [..., 4] -> homogeneous 2D [..., 3]."""
        return hom_points @ self.matrix.T

    def project_cartesian(self, points: np.ndarray) -> np.ndarray:
        """Project 3D points (cartesian or homogeneous) -> 2D pixel coords [..., 2]."""
        hom = ensure_homogeneous(points, d=3)
        return homogeneous_to_cartesian(self.project(hom))

    def back_project(self, pixels: np.ndarray, depths: np.ndarray) -> np.ndarray:
        """Invert projection given pixel coords [..., 2] and depths [...].

        Requires the conventional third row [0, 0, 1, 0] so that the
        projective scale equals the depth.
        """
        assert np.allclose(self.matrix[2], [0.0, 0.0, 1.0, 0.0]), (
            "back_project requires third intrinsic row [0, 0, 1, 0]"
        )
        depths = np.asarray(depths, dtype=np.float64)
        m2 = self.matrix[:2, :2]
        # [u, v] * Z = m2 @ [X, Y] + col2 * Z + col3
        rhs = pixels * depths[..., None]
        rhs = rhs - self.matrix[:2, 2] * depths[..., None] - self.matrix[:2, 3]
        xy = rhs @ np.linalg.inv(m2).T
        return np.concatenate([xy, depths[..., None]], axis=-1)

    def __repr__(self) -> str:
        return f"CameraIntrinsics(matrix={self.matrix!r})"
