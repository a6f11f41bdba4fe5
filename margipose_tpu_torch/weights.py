"""Weights bridge: JAX ``{params, batch_stats}`` trees -> the port's state_dict.

The port's modules carry the reference torch ``state_dict`` keys, so a tree
exported from the JAX package loads with ``load_state_dict(strict=True)``.
This is the port's own copy of the key mapping in
``margipose_tpu/train/torch_import.py`` (``flax_path_to_torch_keys``,
``export_state_dict``), for MargiPose and Chatterbox:

  * flax path components map to dotted torch keys (``BatchNorm_0`` dropped,
    scale/mean/var renamed, ``hm_combiners_0`` -> ``hm_combiners.0``, and
    Chatterbox's ``down_N``/``up_N``/``resample_N`` -> ``down_convs.N``/
    ``up_convs.N``/``resample.N``);
  * the vmapped columns ``hm_cnns_{down,up}_<t>`` hold three planes stacked
    on a leading axis, split here into ``{xy,zy,xz}_hm_cnns.<t>.*_layers``;
  * conv kernels go HWIO -> OIHW; transposed-conv kernels, stored flipped
    for the dilated forward conv, go back to torch's IOHW with the flip undone.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_DROP_COMPONENTS = {"BatchNorm_0"}
_LEAF_RENAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
# Transposed-conv weight locations (margipose up-stride blocks; chatterbox
# up path). Everything else with a 4D 'weight' is a regular conv.
_TRANSPOSE_CONVS = [
    re.compile(r"up_layers\.2\.(module|shortcut)\.0\.weight$"),
    re.compile(r"(zy|xz)_hm_cnn\.up_convs\.0\.weight$"),
    re.compile(r"(zy|xz)_hm_cnn\.up_convs\.[3-6]\.(conv1|resample\.0)\.weight$"),
]
_STACK_PLANES = ("xy", "zy", "xz")
_STACKED_COLUMN = re.compile(r"hm_cnns_(down|up)_(\d+)")
# flattened list attributes (xy_hm_cnns_0 -> xy_hm_cnns.0), chatterbox
# sequential indices (down_0 -> down_convs.0) and its resample shortcut
# (resample_0 -> resample.0)
_COMPONENT_RENAMES = [
    (re.compile(r"(xy_hm_cnns|zy_hm_cnns|xz_hm_cnns|hm_combiners)_(\d+)"), r"\1"),
    (re.compile(r"(down|up)_(\d+)"), r"\1_convs"),
    (re.compile(r"(resample)_(\d+)"), r"\1"),
]


def _torch_key(path: tuple[str, ...]) -> str:
    comps = [c for c in path if c not in _DROP_COMPONENTS]
    comps[-1] = _LEAF_RENAMES.get(comps[-1], comps[-1])
    out = []
    for c in comps:
        for pattern, head in _COMPONENT_RENAMES:
            m = pattern.fullmatch(c)
            if m:
                out.extend([m.expand(head), m.group(2)])
                break
        else:
            out.append(c)
    return ".".join(out)


def torch_keys(path: tuple[str, ...]) -> list[str]:
    """Reference state_dict key(s) of a flax variable path: three keys (xy,
    zy, xz) for a stacked column leaf, else one."""
    for i, c in enumerate(path):
        m = _STACKED_COLUMN.fullmatch(c)
        if m:
            return [_torch_key(path[:i] + (f"{plane}_hm_cnns_{m.group(2)}",
                                           f"{m.group(1)}_layers") + path[i + 1:])
                    for plane in _STACK_PLANES]
    return [_torch_key(path)]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ``{params, batch_stats}`` tree of
    numpy arrays, including zero ``num_batches_tracked`` buffers."""
    out = {}
    for tree in variables.values():
        for path, value in _flatten(tree):
            keys = torch_keys(path)
            arr = np.asarray(value)
            for key, w in zip(keys, list(arr) if len(keys) > 1 else [arr]):
                if w.ndim == 4 and path[-1] == "weight":
                    if any(p.search(key) for p in _TRANSPOSE_CONVS):
                        w = np.flip(np.transpose(w, (2, 3, 0, 1)), axis=(2, 3))  # -> IOHW
                    else:
                        w = np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW
                # np.array: a fresh C-order copy (torch rejects negative strides)
                out[key] = torch.from_numpy(np.array(w))
    for key in [k for k in out if k.endswith("running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return out
