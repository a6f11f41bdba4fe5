"""Dataset registry: name -> dataset instance.

(reference: src/margipose/data/get_dataset.py:14-58). Adds the
``synthetic[-N]`` names for hermetic runs without real data.

The port's copy of ``margipose_tpu/data/get_dataset.py``: every name, the
augmentation ``seed`` and the error that names both remedies.
"""

from __future__ import annotations

import re
from os import environ, path

from margipose_tpu_torch.data.base import PoseDataset
from margipose_tpu_torch.data.h36m import H36MDataset
from margipose_tpu_torch.data.mixed import MixedPoseDataset
from margipose_tpu_torch.data.mpi_inf_3dhp import MpiInf3dDataset
from margipose_tpu_torch.data.mpii import MpiiDataset
from margipose_tpu_torch.data.synthetic import SyntheticPoseDataset


def base_data_dir() -> str:
    """Resolve the dataset root at call time so ``MARGIPOSE_BASE_DATA_DIR``
    set after import (tests, notebooks) still takes effect."""
    return environ.get('MARGIPOSE_BASE_DATA_DIR', '/datasets')


def get_dataset(dataset_name, data_specs=None, use_aug=False,
                seed=None) -> PoseDataset:
    """Get a dataset instance by name (eg. ``mpi3d-train``).

    ``seed`` seeds the dataset's augmentation randomness (reproducible
    training; see PoseDataset.example_rng). Synthetic datasets ignore it —
    their '@seed' name suffix defines the example POOL, not aug draws.
    """
    try:
        return _get_dataset(dataset_name, data_specs, use_aug, seed)
    except (FileNotFoundError, NotADirectoryError) as e:
        # The bare path the dataset classes raise is cryptic at the CLI
        # (the default train/hyperparams configs reference real corpora,
        # matching the reference's defaults). Same exception type, with
        # the two actionable remedies attached.
        raise type(e)(
            f"{e.args[0] if e.args else e} — dataset {dataset_name!r} "
            f"expects processed data under {base_data_dir()!r}; set "
            f"MARGIPOSE_BASE_DATA_DIR to your dataset root, or use a "
            f"hermetic 'synthetic[-N]' dataset name") from None


def _get_dataset(dataset_name, data_specs, use_aug, seed) -> PoseDataset:
    mpi3d_match = re.fullmatch('mpi3d-(train|val|test|test-uncorrected)', dataset_name)
    if mpi3d_match:
        subset = mpi3d_match[1]
        return MpiInf3dDataset(
            path.join(base_data_dir(), 'mpi3d', subset),
            data_specs=data_specs,
            use_aug=(use_aug and not subset.startswith('test')),
            seed=seed,
        )
    if dataset_name == 'mpi3d-trainval':
        return MixedPoseDataset([
            _get_dataset('mpi3d-train', data_specs, use_aug, seed),
            _get_dataset('mpi3d-val', data_specs, use_aug,
                         None if seed is None else seed + 1),
        ], balanced_sampling=False)

    h36m_match = re.fullmatch('h36m-(trainval|test)', dataset_name)
    if h36m_match:
        subset = h36m_match[1]
        return H36MDataset(
            path.join(base_data_dir(), 'h36m'),
            data_specs=data_specs, subset=subset,
            use_aug=(use_aug and subset != 'test'),
            seed=seed,
        )

    mpii_match = re.fullmatch('mpii-(train|val|trainval|test)', dataset_name)
    if mpii_match:
        subset = mpii_match[1]
        return MpiiDataset(
            path.join(base_data_dir(), 'mpii'),
            data_specs=data_specs, subset=subset,
            use_aug=(use_aug and subset != 'test'),
            seed=seed,
        )

    # optional '@seed' suffix gives disjoint procedural pools, eg.
    # 'synthetic-64@1' for a validation set that does not overlap the
    # 'synthetic-512' (seed 0) training set
    synth_match = re.fullmatch(r'synthetic(?:-(\d+))?(?:@(\d+))?', dataset_name)
    if synth_match:
        length = int(synth_match[1]) if synth_match[1] else 256
        seed = int(synth_match[2]) if synth_match[2] else 0
        return SyntheticPoseDataset(
            data_specs=data_specs, length=length, use_aug=use_aug, seed=seed)

    raise ValueError(f'unrecognised dataset: {dataset_name}')
