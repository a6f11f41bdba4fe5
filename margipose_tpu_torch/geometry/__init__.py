from margipose_tpu_torch.geometry.coords import (
    cartesian_to_homogeneous,
    ensure_cartesian,
    ensure_homogeneous,
    homogeneous_to_cartesian,
)
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.normaliser import SkeletonNormaliser

__all__ = [
    "CameraIntrinsics",
    "SkeletonNormaliser",
    "cartesian_to_homogeneous",
    "ensure_cartesian",
    "ensure_homogeneous",
    "homogeneous_to_cartesian",
]
