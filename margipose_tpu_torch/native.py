"""ctypes bindings for the port's host-ops library (``csrc/host_ops.cpp``).

Counterpart of ``margipose_tpu/native.py``, with its functions and names.
The library fuses the per-example host transform (affine warp + colour
jitter + normalisation) into one C++ pass, in place of PIL's multi-pass
pipeline; ``geometry/transforms.py`` and ``bin/serve.letterbox_uint8`` take
it wherever the JAX package takes its own, so the port's pixels are the JAX
package's bit for bit.

It is built by g++ at first use into ``build/margipose_tpu_torch/``
(``ops/_build.py``). ``MARGIPOSE_DISABLE_NATIVE`` selects the PIL path, as
in JAX. Where JAX falls back to PIL when the build fails, the port raises:
PIL's pixels differ from the library's by a few uint8 LSBs, and no path of
the port changes its results without saying so.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from margipose_tpu_torch.ops import _build

LIBRARY = "host_ops"

_lock = threading.Lock()
_lib = None


def _load():
    """The bound library, built first if needed; None where
    ``MARGIPOSE_DISABLE_NATIVE`` is set. Raises if the build fails."""
    global _lib
    if os.environ.get("MARGIPOSE_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            lib = _build.load(LIBRARY)
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            c_int, c_float = ctypes.c_int, ctypes.c_float
            lib.mp_warp_rgb_u8.argtypes = [u8p, c_int, c_int, f32p, u8p, c_int, c_int]
            lib.mp_warp_rgb_u8.restype = c_int
            lib.mp_warp_colour_norm.argtypes = [
                u8p, c_int, c_int, f32p, c_float, c_float, c_float, c_float,
                ctypes.c_void_p, ctypes.c_void_p, f32p, c_int, c_int,
            ]
            lib.mp_warp_colour_norm.restype = c_int
            lib.mp_composite_u8.argtypes = [u8p, u8p, u8p, u8p, c_int, c_int]
            lib.mp_composite_u8.restype = c_int
            _lib = lib
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the host-ops library is disabled (MARGIPOSE_DISABLE_NATIVE)")
    return lib


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise ValueError(f"{fn} rejected its arguments (rc {rc})")


def available() -> bool:
    """True unless ``MARGIPOSE_DISABLE_NATIVE`` is set; builds the library
    at first call and raises if that fails."""
    return _load() is not None


def _inv_coeffs(affine: np.ndarray) -> np.ndarray:
    """output<-input 3x3 affine -> PIL-order input<-output 6 coeffs."""
    inv = np.linalg.inv(np.asarray(affine, np.float64))
    return np.ascontiguousarray(inv[:2].reshape(-1), np.float32)


def _rgb(image: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(image, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected an HWC RGB image, got shape {src.shape}")
    return src


def warp_rgb(image: np.ndarray, affine: np.ndarray, out_size) -> np.ndarray:
    """Warp an HWC uint8 RGB array with an output<-input affine.
    ``out_size`` is (width, height) like PIL."""
    lib = _require()
    ow, oh = out_size
    src = _rgb(image)
    dst = np.empty((oh, ow, 3), np.uint8)
    _check(lib.mp_warp_rgb_u8(src, src.shape[0], src.shape[1], _inv_coeffs(affine),
                              dst, oh, ow), "mp_warp_rgb_u8")
    return dst


def warp_colour_norm(image: np.ndarray, affine: np.ndarray, out_size,
                     brightness=1.0, contrast=1.0, saturation=1.0, hue=0.0,
                     mean=None, std=None) -> np.ndarray:
    """Fused warp + colour jitter (+ normalise) to float32 HWC."""
    lib = _require()
    ow, oh = out_size
    src = _rgb(image)
    dst = np.empty((oh, ow, 3), np.float32)
    if (mean is None) != (std is None):
        raise ValueError("pass both mean and std, or neither")
    if mean is not None:
        # kept referenced until the call returns
        mean = np.ascontiguousarray(mean, np.float32).reshape(3)
        std = np.ascontiguousarray(std, np.float32).reshape(3)
        mean_p = mean.ctypes.data_as(ctypes.c_void_p)
        std_p = std.ctypes.data_as(ctypes.c_void_p)
    else:
        mean_p = std_p = None
    _check(lib.mp_warp_colour_norm(
        src, src.shape[0], src.shape[1], _inv_coeffs(affine),
        float(brightness), float(contrast), float(saturation), float(hue),
        mean_p, std_p, dst, oh, ow), "mp_warp_colour_norm")
    return dst


def composite(fg: np.ndarray, bg: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """PIL Image.composite(fg, bg, mask) for HWC uint8 RGB + L-mode mask."""
    lib = _require()
    fg, bg = _rgb(fg), _rgb(bg)
    mask = np.ascontiguousarray(mask, np.uint8)
    if bg.shape != fg.shape or mask.shape != fg.shape[:2]:
        raise ValueError(f"shapes differ: fg {fg.shape}, bg {bg.shape}, mask {mask.shape}")
    dst = np.empty_like(fg)
    _check(lib.mp_composite_u8(fg, bg, mask, dst, fg.shape[0], fg.shape[1]),
           "mp_composite_u8")
    return dst
