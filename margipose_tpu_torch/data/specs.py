"""Input/output data specifications.

(reference: src/margipose/data_specs.py:26-64). Images are numpy HWC float32
(the bins turn a batch into NCHW on the device); ``convert`` maps a PIL image
to a normalised array, ``unconvert`` inverts it, and ``device_input`` uploads
a batch, as uint8 (``requantize``, then ``device_renormalize``) or float32.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import PIL.Image
import torch


class ImageSpecs:
    IMAGENET_MEAN = [0.485, 0.456, 0.406]
    IMAGENET_STDDEV = [0.229, 0.224, 0.225]

    def __init__(self, resolution, mean=None, stddev=None):
        if isinstance(resolution, Sequence):
            self.height, self.width = resolution
        else:
            self.height = self.width = resolution
        self.mean = mean
        self.stddev = stddev

    def convert(self, img: PIL.Image.Image) -> np.ndarray:
        """PIL image -> normalised HWC float32 array."""
        if img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.mean is not None:
            arr = arr - np.asarray(self.mean, dtype=np.float32)
        if self.stddev is not None:
            arr = arr / np.asarray(self.stddev, dtype=np.float32)
        return arr

    def requantize(self, arr: np.ndarray) -> np.ndarray:
        """Invert ``convert`` back to the EXACT source uint8 pixels.

        Every host pipeline path materialises a uint8 image immediately
        before ``convert`` (the fused native warp rounds to uint8 in
        geometry/transforms.py to match PIL's behaviour; PIL's own warp runs
        only under ``MARGIPOSE_DISABLE_NATIVE``), so the
        normalised input is always ``(u/255 - mean)/std`` of integer pixel
        values and ``round((x*std + mean)*255)`` recovers u exactly
        (float32 round-trip error ~1e-5 << the 0.5 rounding threshold).
        Shipping uint8 to the device is therefore lossless versus shipping
        the float32 input while moving 4x fewer bytes; re-normalise on
        device with ``(u/255 - mean)/std``."""
        arr = np.asarray(arr, np.float32)
        mean = np.asarray(self.mean if self.mean is not None else 0.0,
                          np.float32)
        std = np.asarray(self.stddev if self.stddev is not None else 1.0,
                         np.float32)
        return np.clip(np.rint((arr * std + mean) * 255.0), 0, 255).astype(
            np.uint8)

    def unconvert(self, arr: np.ndarray) -> PIL.Image.Image:
        """Normalised HWC array -> PIL image."""
        arr = np.asarray(arr, dtype=np.float32)
        if self.stddev is not None:
            arr = arr * np.asarray(self.stddev, dtype=np.float32)
        if self.mean is not None:
            arr = arr + np.asarray(self.mean, dtype=np.float32)
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        return PIL.Image.fromarray(arr, "RGB")


def device_renormalize(images: torch.Tensor, specs: ImageSpecs | None) -> torch.Tensor:
    """Device-side inverse of ``ImageSpecs.requantize``: uint8 NHWC pixels ->
    normalised float32 NCHW, ``(u/255 - mean)/std`` (counterpart of
    ``margipose_tpu/data/specs.py::device_renormalize``, which stays NHWC).

    The one definition every uint8-shipping path (eval, train, serve) uses.
    It differs from the host's ``convert`` only at the last ulp. ``specs``
    may be None (identity normalisation)."""
    mean = specs.mean if specs is not None and specs.mean is not None else 0.0
    std = specs.stddev if specs is not None and specs.stddev is not None else 1.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    out = (images.to(torch.float32) / 255.0 - mean) / std
    return out.permute(0, 3, 1, 2).contiguous()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory, without waiting,
    on the card."""
    t = torch.from_numpy(arr)
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t


def device_input(arr: np.ndarray, device: torch.device,
                 ship_specs: ImageSpecs | None = None) -> torch.Tensor:
    """A host NHWC input batch -> the model's NCHW float32 input on
    ``device``: the one upload rule of eval, train and serve. With
    ``ship_specs`` it goes up as its exact uint8 source pixels
    (``requantize``: 4x fewer bytes, lossless; a uint8 ``arr`` is those
    pixels already) and is renormalised there. Without, ``arr`` is the
    host-normalised float32 input."""
    if ship_specs is None:
        return to_device(np.asarray(arr, np.float32), device).permute(0, 3, 1, 2).contiguous()
    pixels = arr if arr.dtype == np.uint8 else ship_specs.requantize(arr)
    return device_renormalize(to_device(np.ascontiguousarray(pixels), device), ship_specs)


class JointsSpecs:
    def __init__(self, skeleton_desc, n_dims: int = 3):
        self.skeleton_desc = skeleton_desc
        self.n_dims = n_dims


class DataSpecs:
    """Specifications for the input and output data of a pose model."""

    def __init__(self, input_specs: ImageSpecs, output_specs: JointsSpecs):
        self._input_specs = input_specs
        self._output_specs = output_specs

    @property
    def input_specs(self) -> ImageSpecs:
        return self._input_specs

    @property
    def output_specs(self) -> JointsSpecs:
        return self._output_specs

    def __eq__(self, other):
        if not isinstance(other, DataSpecs):
            return NotImplemented
        a, b = self.input_specs, other.input_specs
        return (
            (a.height, a.width, a.mean, a.stddev)
            == (b.height, b.width, b.mean, b.stddev)
            and self.output_specs.skeleton_desc.joint_names
            == other.output_specs.skeleton_desc.joint_names
            and self.output_specs.n_dims == other.output_specs.n_dims
        )
