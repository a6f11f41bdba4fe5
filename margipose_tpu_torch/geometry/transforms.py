"""Invertible joint-aware 2D image transform pipeline.

Reimplements the capability surface of ``pose3d_utils.transformers`` /
``pose3d_utils.transforms`` used by the reference augmentation pipeline
(Pan -> Rotate -> Zoom -> HFlip -> SquareCrop -> ChangeResolution ->
AdjustColour; reference: src/margipose/data/__init__.py:97-115), redesigned
around a single composed affine:

  * The whole geometric pipeline is one 2D affine ``A`` on pixel coordinates,
    built directly from the reference ``transform_opts`` dict schema
    (centre_x/centre_y, rotation, scale, hflip, out_width/out_height).
  * ``A`` is absorbed into the camera intrinsics (K' = A @ K), so 3D points
    keep their original camera-space coordinates. The only point-side effect
    is the hflip joint relabelling (left<->right), which is exactly
    invertible (``untransform``).
  * The image is resampled once (bilinear) with the composed affine, on the
    host by the port's native host ops (``margipose_tpu_torch.native``, the
    JAX package's library, copied) or, under ``MARGIPOSE_DISABLE_NATIVE``,
    by PIL. (The JAX package's on-device augmentation is not ported yet.)

This factoring is mathematically equivalent to the reference's staged
camera/point transforms: the normalised targets, the transformed camera's
projections, and the untransformed skeletons all agree by construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import PIL.Image
from PIL import ImageEnhance

from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.coords import ensure_homogeneous


def _translation(tx: float, ty: float) -> np.ndarray:
    m = np.eye(3)
    m[0, 2] = tx
    m[1, 2] = ty
    return m


def _scale(sx: float, sy: float) -> np.ndarray:
    return np.diag([sx, sy, 1.0])


def _rotation(degrees: float) -> np.ndarray:
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def build_affine(opts: dict) -> np.ndarray:
    """Compose the pipeline affine from a reference-schema transform_opts dict.

    Output pixel = A @ input pixel. The output image is an
    ``out_width x out_height`` view of a square crop of side
    ``scale * min(in_width, in_height)`` centred on (centre_x, centre_y),
    rotated by ``rotation`` degrees, optionally mirrored horizontally.
    """
    crop = float(opts["scale"]) * min(opts["in_width"], opts["in_height"])
    out_w, out_h = opts["out_width"], opts["out_height"]
    flip = -1.0 if opts.get("hflip", False) else 1.0
    return (
        _translation(out_w / 2.0, out_h / 2.0)
        @ _scale(flip * out_w / crop, out_h / crop)
        @ _rotation(float(opts.get("rotation", 0.0)))
        @ _translation(-float(opts["centre_x"]), -float(opts["centre_y"]))
    )


def warp_image_pil(image: PIL.Image.Image, affine: np.ndarray, out_size) -> PIL.Image.Image:
    """Resample ``image`` with the given output<-input affine (bilinear)."""
    inv = np.linalg.inv(affine)
    coeffs = tuple(inv[:2].reshape(-1))
    return image.transform(out_size, PIL.Image.AFFINE, coeffs, PIL.Image.BILINEAR)


def adjust_colour_pil(img: PIL.Image.Image, brightness=1.0, contrast=1.0,
                      saturation=1.0, hue=0.0) -> PIL.Image.Image:
    """torchvision-style colour jitter on a PIL image (fixed order:
    brightness -> contrast -> saturation -> hue)."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    if brightness != 1.0:
        img = ImageEnhance.Brightness(img).enhance(brightness)
    if contrast != 1.0:
        img = ImageEnhance.Contrast(img).enhance(contrast)
    if saturation != 1.0:
        img = ImageEnhance.Color(img).enhance(saturation)
    if hue != 0.0:
        assert -0.5 <= hue <= 0.5, "hue must be in [-0.5, 0.5]"
        # Convention note: the hue shift rounds to the nearest of 255 HSV
        # steps; torchvision's PIL backend TRUNCATES (np.uint8(hue*255)),
        # i.e. may differ by one step. The reference's colour jitter lives
        # in pose3d_utils' AdjustColour (source unavailable in this
        # environment), so which convention it used is unverifiable; this
        # only perturbs augmentation draws, never the eval path.
        h, s, v = img.convert("HSV").split()
        h_arr = np.array(h, dtype=np.uint8)
        h_arr = (h_arr.astype(np.int16) + int(round(hue * 255))).astype(np.uint8)
        img = PIL.Image.merge("HSV", (PIL.Image.fromarray(h_arr, "L"), s, v)).convert("RGB")
    return img


@dataclass
class PointTransformer:
    """The point-side of the pipeline: hflip joint relabelling only
    (all geometry lives in the camera). Exactly invertible."""

    hflip: bool
    hflip_indices: list

    def transform(self, points: np.ndarray) -> np.ndarray:
        points = ensure_homogeneous(points, d=3)
        if self.hflip:
            points = np.take(points, self.hflip_indices, axis=-2)
        return points

    def untransform(self, points: np.ndarray) -> np.ndarray:
        points = ensure_homogeneous(np.asarray(points, dtype=np.float64), d=3)
        if self.hflip:
            inverse = np.argsort(np.asarray(self.hflip_indices))
            points = np.take(points, inverse, axis=-2)
        return points


class TransformerContext:
    """Applies the composed pipeline to (camera, image, points).

    Built from the reference-schema ``transform_opts`` dict; replaces the
    reference's TransformerContext.add(...) staging
    (reference: src/margipose/data/__init__.py:97-108).
    """

    def __init__(self, opts: dict):
        self.opts = opts
        self.affine = build_affine(opts)
        self.point_transformer = PointTransformer(
            hflip=bool(opts.get("hflip", False)),
            hflip_indices=list(opts["hflip_indices"]),
        )

    def transform(self, camera: CameraIntrinsics, image, points):
        new_camera = camera.affine_transformed(self.affine)
        new_points = self.point_transformer.transform(points)
        new_image = None
        if image is not None:
            out_size = (self.opts["out_width"], self.opts["out_height"])
            b = self.opts.get("brightness", 1.0)
            c = self.opts.get("contrast", 1.0)
            s = self.opts.get("saturation", 1.0)
            h = self.opts.get("hue", 0.0)
            # ``image`` may be a PIL RGB image or an HWC uint8 array (the
            # compositing pipeline stays in numpy; see data/mpi_inf_3dhp.py).
            is_array = isinstance(image, np.ndarray)
            if is_array or image.mode == "RGB":
                # Fused native warp+colour pass (one C++ loop instead of a
                # PIL transform + three enhance passes), where the JAX
                # package takes it. It computes in ONE float32 loop with a
                # single final uint8 round; PIL quantises to uint8 after the
                # warp and after each enhance pass, so the two differ by a
                # few uint8 LSBs on augmented pixels. The library raises if
                # it cannot be built; MARGIPOSE_DISABLE_NATIVE selects PIL.
                from margipose_tpu_torch import native

                if native.available():
                    arr = native.warp_colour_norm(
                        image if is_array else np.asarray(image),
                        self.affine, out_size,
                        brightness=b, contrast=c, saturation=s, hue=h)
                    new_image = PIL.Image.fromarray(
                        (arr * 255.0 + 0.5).astype(np.uint8), "RGB")
            if new_image is None:
                if is_array:
                    image = PIL.Image.fromarray(image, "RGB")
                new_image = warp_image_pil(image, self.affine, out_size)
                new_image = adjust_colour_pil(
                    new_image, brightness=b, contrast=c, saturation=s, hue=h)
        return new_camera, new_image, new_points

    def untransform(self, points: np.ndarray) -> np.ndarray:
        return self.point_transformer.untransform(points)
