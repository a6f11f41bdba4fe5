"""Mixed multi-dataset training with round-robin balanced sampling.

(reference: src/margipose/data/mixed.py:6-110)
"""

from __future__ import annotations

import numpy as np

from margipose_tpu_torch.data.base import PoseDataset, derive_epoch_rng


class RoundRobinSampler:
    """Alternates sources 1:1 per batch position, reshuffling each epoch
    (reference: src/margipose/data/mixed.py:6-24)."""

    def __init__(self, index_lists, num_samples, seed=None):
        self.index_lists = [list(l) for l in index_lists]
        self.num_samples = num_samples
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def _emit(self, rng):
        shuffled = [list(l) for l in self.index_lists]
        for l in shuffled:
            rng.shuffle(l)
        i = 0
        js = [0] * len(shuffled)
        for _ in range(len(self)):
            yield shuffled[i][js[i] % len(shuffled[i])]
            js[i] += 1
            i = (i + 1) % len(js)

    def __iter__(self):
        return self._emit(self.rng)

    def iter_epoch(self, epoch):
        """Epoch-pinned order: a pure function of (seed, epoch), so resumed
        runs see the same shuffles as uninterrupted ones (see
        base.RandomSampler.iter_epoch)."""
        if self.seed is None:
            return iter(self)
        return self._emit(derive_epoch_rng(self.seed, epoch))

    def __len__(self):
        return self.num_samples


class MixedPoseDataset(PoseDataset):
    """Multiple pose datasets combined into one
    (reference: src/margipose/data/mixed.py:27-110)."""

    def __init__(self, datasets, balanced_sampling=True, seed=None):
        data_specs = datasets[0].data_specs
        for dataset in datasets[1:]:
            assert dataset.data_specs == data_specs, \
                'combined datasets must have same data specs'
        super().__init__(data_specs)

        self.datasets = datasets
        self.dataset_lengths = [len(d) for d in datasets]
        self.length = sum(self.dataset_lengths)
        self.balanced_sampling = balanced_sampling
        self.seed = seed
        # shared fixed raw frame size enables on-device augmentation for the
        # combination (eg. mpi3d-trainval = mpi3d-train + mpi3d-val at 768px)
        sizes = {d.raw_size for d in datasets}
        self.raw_size = sizes.pop() if len(sizes) == 1 else None

        self.per_dataset_indices = [[] for _ in datasets]
        offset = 0
        for di, length in enumerate(self.dataset_lengths):
            self.per_dataset_indices[di] = list(range(offset, offset + length))
            offset += length

    def _decompose_index(self, index):
        upper = 0
        for i, length in enumerate(self.dataset_lengths):
            offset = upper
            upper += length
            if index < upper:
                return i, index - offset
        raise IndexError('index out of bounds')

    def sampler(self, examples_per_epoch=None, seed=None):
        if not self.balanced_sampling:
            return super().sampler(examples_per_epoch, seed=seed)
        return RoundRobinSampler(
            self.per_dataset_indices, examples_per_epoch or len(self),
            seed=seed if seed is not None else self.seed,
        )

    def _evaluate_3d(self, index, original_skel, norm_pred, camera_intrinsics,
                     transform_opts):
        dataset_index, example_index = self._decompose_index(index)
        return self.datasets[dataset_index]._evaluate_3d(
            example_index, original_skel, norm_pred, camera_intrinsics,
            transform_opts['opts'])

    def to_image_space(self, index, normalised, intrinsics):
        dataset_index, example_index = self._decompose_index(index)
        return self.datasets[dataset_index].to_image_space(
            example_index, normalised, intrinsics)

    def untransform_skeleton(self, denorm_skel, trans_opts):
        dataset_index = trans_opts['dataset_index']
        return self.datasets[dataset_index].untransform_skeleton(
            denorm_skel, trans_opts['opts'])

    def to_canonical_skeleton(self, skel):
        return self.datasets[0].to_canonical_skeleton(skel)

    @property
    def device_aug(self):
        return all(d.device_aug for d in self.datasets)

    @device_aug.setter
    def device_aug(self, value):
        for d in self.datasets:
            d.device_aug = value

    @property
    def device_aug_canvas(self):
        canvases = {d.device_aug_canvas for d in self.datasets}
        return canvases.pop() if len(canvases) == 1 else None

    @device_aug_canvas.setter
    def device_aug_canvas(self, value):
        for d in self.datasets:
            d.device_aug_canvas = value

    @property
    def device_aug_crop(self):
        return all(d.device_aug_crop for d in self.datasets)

    @device_aug_crop.setter
    def device_aug_crop(self, value):
        for d in self.datasets:
            d.device_aug_crop = value

    def __len__(self):
        return self.length

    # Fields common to every source dataset in both augmentation modes —
    # 'input' for host-aug, raw_image/aug_* for device-aug. Dataset-specific
    # extras (frame_ref, mpii's normalize, ...) are dropped: collate takes
    # its key set from a batch's first sample, so a key present in only one
    # source would crash mixed batches.
    _PASS_FIELDS = ('valid_depth', 'original_skel', 'camera_intrinsic',
                    'camera_extrinsic', 'target', 'joint_mask',
                    'input', 'raw_image', 'aug_affine', 'aug_colour')

    def __getitem__(self, index):
        dataset_index, example_index = self._decompose_index(index)
        example = self.datasets[dataset_index][example_index]
        out = {k: example[k] for k in self._PASS_FIELDS if k in example}
        out['index'] = index
        out['transform_opts'] = {
            'dataset_index': dataset_index,
            'opts': example['transform_opts'],
        }
        return out
