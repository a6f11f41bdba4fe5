"""Dataset lookup by name (counterpart of ``margipose_tpu/data/get_dataset.py``).

Only the procedural ``synthetic[-N][@seed]`` dataset, which needs nothing on
disk, is ported so far; the MPI-INF-3DHP, Human3.6M, MPII and mixed datasets
raise until their slice lands.
"""

from __future__ import annotations

import re

from margipose_tpu_torch.data.synthetic import SyntheticPoseDataset


def get_dataset(dataset_name, data_specs=None, use_aug=False):
    # 'synthetic-64@1': 64 examples from a pool disjoint from seed 0's
    synth_match = re.fullmatch(r'synthetic(?:-(\d+))?(?:@(\d+))?', dataset_name)
    if synth_match:
        length = int(synth_match[1]) if synth_match[1] else 256
        seed = int(synth_match[2]) if synth_match[2] else 0
        return SyntheticPoseDataset(
            data_specs=data_specs, length=length, use_aug=use_aug, seed=seed)
    raise NotImplementedError(
        f'dataset {dataset_name!r} is not yet ported to margipose_tpu_torch '
        '(only synthetic[-N][@seed] is)')
