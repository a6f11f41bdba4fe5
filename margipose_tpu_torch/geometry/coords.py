"""Cartesian/homogeneous coordinate helpers (host-side, numpy float64).

Reimplements the ``pose3d_utils.coords`` API surface used by the reference
(see reference call sites: src/margipose/eval.py:4, src/margipose/data/__init__.py:6).
"""

from __future__ import annotations

import numpy as np


def cartesian_to_homogeneous(cart: np.ndarray) -> np.ndarray:
    ones = np.ones_like(cart[..., :1])
    return np.concatenate([cart, ones], axis=-1)


def homogeneous_to_cartesian(hom: np.ndarray) -> np.ndarray:
    return hom[..., :-1] / hom[..., -1:]


def ensure_homogeneous(coords: np.ndarray, d: int) -> np.ndarray:
    """Return ``coords`` with a trailing w component (d+1 values per point)."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.shape[-1] == d + 1:
        return coords
    assert coords.shape[-1] == d, f"expected {d} or {d + 1} coords, got {coords.shape[-1]}"
    return cartesian_to_homogeneous(coords)


def ensure_cartesian(coords: np.ndarray, d: int) -> np.ndarray:
    """Return ``coords`` as cartesian (d values per point)."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.shape[-1] == d:
        return coords
    assert coords.shape[-1] == d + 1, f"expected {d} or {d + 1} coords, got {coords.shape[-1]}"
    return homogeneous_to_cartesian(coords)
