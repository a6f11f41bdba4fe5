"""Pose dataset base class, samplers, and batch collation.

Host-side re-design of the reference's dataset layer
(reference: src/margipose/data/__init__.py:23-232). Datasets are plain
Python classes producing numpy sample dicts; batching is done by a
thread-based loader (see ``margipose_tpu_torch.data.loader``) producing
fixed-shape NHWC numpy batches for device prefetch.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from margipose_tpu_torch.data.specs import DataSpecs
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.geometry.normaliser import SkeletonNormaliser
from margipose_tpu_torch.geometry.skeleton import (
    SkeletonDesc,
    make_eval_scale_bone_lengths,
    make_eval_scale_skeleton_height,
)
from margipose_tpu_torch.geometry.transforms import TransformerContext

# Thread-local sampler ordinal used to derive per-example augmentation RNGs
# (see PoseDataset.example_rng). Set by the loaders around each dataset
# access; module-level so mixed datasets delegating to children on the same
# thread see the same ordinal.
import threading

_AUG_TL = threading.local()


def set_aug_ordinal(value) -> None:
    """Set (or clear, with None) the calling thread's ``(epoch, position)``
    sampler ordinal. Loader-internal: with an ordinal in place, datasets
    derive each example's augmentation RNG from (seed, ordinal, index), so
    augmentation is deterministic for ANY ``num_workers`` — the draws depend
    on the sampler position, never on thread scheduling. (The reference
    seeds each worker PROCESS instead — reference:
    src/margipose/data/__init__.py:189-190 — which is deterministic only for
    a fixed worker count.)"""
    if value is None:
        _AUG_TL.__dict__.pop('ordinal', None)
    else:
        _AUG_TL.ordinal = value


def as_rgb_array(img) -> np.ndarray:
    """HWC uint8 view/copy of a PIL RGB image or passthrough for arrays."""
    if isinstance(img, np.ndarray):
        return img
    return np.asarray(img.convert('RGB') if img.mode != 'RGB' else img)


class PoseDataset(ABC):
    raw_size = None  # (height, width) of raw frames, when fixed

    def __init__(self, data_specs: DataSpecs):
        self.data_specs = data_specs
        self.skeleton_normaliser = SkeletonNormaliser()

    # ------------------------------------------------------------------ #
    # Augmentation RNG
    # ------------------------------------------------------------------ #

    def _init_example_rng(self, seed):
        """Set up augmentation randomness. ``self.rng`` remains the legacy
        shared stream (used for direct ``dataset[i]`` access outside a
        loader, e.g. the GUI); ``example_rng`` below derives an independent
        per-example RandomState from ``seed`` for loader-driven access."""
        self.rng = np.random.RandomState(seed)
        # unseeded datasets still get thread-safe (if non-reproducible)
        # per-example streams via a process-random salt
        self._aug_seed = (int(seed) if seed is not None
                          else int(self.rng.randint(0, 2 ** 31)))

    def example_rng(self, index) -> np.random.RandomState:
        """Per-example augmentation RandomState.

        Under a loader (which sets the thread-local sampler ordinal — see
        ``set_aug_ordinal``), the stream is a pure function of
        ``(dataset seed, epoch, sampler position, index)``: thread-safe and
        bit-deterministic for ANY ``num_workers``, with repeated indices in
        an epoch (samplers with replacement) still drawing fresh
        augmentations via their distinct sampler positions. Outside a
        loader it falls back to the legacy shared ``self.rng`` stream so
        direct indexing keeps its draw-variety semantics."""
        ordinal = _AUG_TL.__dict__.get('ordinal')
        if ordinal is None:
            return self.rng
        seed = np.random.SeedSequence(
            [self._aug_seed, *ordinal, int(index)]).generate_state(1)[0]
        return np.random.RandomState(seed)

    # ------------------------------------------------------------------ #
    # Sampling
    # ------------------------------------------------------------------ #

    def sampler(self, examples_per_epoch=None, seed=None):
        """Uniform random sampler; with replacement only when
        examples_per_epoch exceeds the dataset size
        (reference: src/margipose/data/__init__.py:28-40)."""
        return RandomSampler(len(self), examples_per_epoch, seed=seed)

    # ------------------------------------------------------------------ #
    # Conversions
    # ------------------------------------------------------------------ #

    def input_to_pil_image(self, arr):
        return self.data_specs.input_specs.unconvert(arr)

    def input_to_tensor(self, img):
        return self.data_specs.input_specs.convert(img)

    @property
    def skeleton_desc(self) -> SkeletonDesc:
        return self.data_specs.output_specs.skeleton_desc

    # ------------------------------------------------------------------ #
    # Normalisation (reference: src/margipose/data/__init__.py:52-95)
    # ------------------------------------------------------------------ #

    def denormalise_with_depth(self, normalised_skel, z_ref, intrinsics):
        return self.skeleton_normaliser.denormalise_skeleton(
            ensure_homogeneous(np.asarray(normalised_skel, np.float64), d=3),
            z_ref,
            intrinsics,
            self.data_specs.input_specs.height,
            self.data_specs.input_specs.width,
        )

    def denormalise(self, normalised_skel, eval_scale, intrinsics):
        normalised_skel = ensure_homogeneous(
            np.asarray(normalised_skel, np.float64), d=3
        )
        z_ref = self.skeleton_normaliser.infer_depth(
            normalised_skel,
            eval_scale,
            intrinsics,
            self.data_specs.input_specs.height,
            self.data_specs.input_specs.width,
        )
        return self.denormalise_with_depth(normalised_skel, z_ref, intrinsics)

    def denormalise_with_reference(self, normalised_skel, ref_skel, intrinsics, trans_opts):
        untransform = lambda skel: self.untransform_skeleton(skel, trans_opts)
        eval_scale = make_eval_scale_bone_lengths(self.skeleton_desc, untransform, ref_skel)
        return self.denormalise(normalised_skel, eval_scale, intrinsics)

    def denormalise_with_skeleton_height(self, normalised_skel, intrinsics, trans_opts):
        untransform = lambda skel: self.untransform_skeleton(skel, trans_opts)
        eval_scale = make_eval_scale_skeleton_height(self.skeleton_desc, untransform)
        return self.denormalise(normalised_skel, eval_scale, intrinsics)

    def to_image_space(self, index, normalised, intrinsics):
        z_ref = 100  # depth is irrelevant for a 2D projection
        denormalised = self.denormalise_with_depth(normalised, z_ref, intrinsics)
        return intrinsics.project_cartesian(denormalised)

    # ------------------------------------------------------------------ #
    # Transforms (reference: src/margipose/data/__init__.py:97-115)
    # ------------------------------------------------------------------ #

    @staticmethod
    def create_transformer_context(opts) -> TransformerContext:
        return TransformerContext(opts)

    def untransform_skeleton(self, denorm_skel, trans_opts):
        """Transform a denormalised skeleton back into universal camera space."""
        ctx = self.create_transformer_context(trans_opts)
        return ctx.untransform(denorm_skel)

    # ------------------------------------------------------------------ #
    # Evaluation
    # ------------------------------------------------------------------ #

    @abstractmethod
    def to_canonical_skeleton(self, skel):
        """Convert output skeleton into a canonical 17-joint skeleton."""

    def _evaluate_3d(self, index, original_skel, norm_pred, camera_intrinsics,
                     transform_opts):
        raise NotImplementedError()

    def evaluate_3d_batch(self, batch, norm_preds):
        """(reference: src/margipose/data/__init__.py:135-146)"""
        valid_depth = np.asarray(batch.get('valid_depth_host',
                                           batch['valid_depth']))
        return [
            self._evaluate_3d(
                batch['index'][i],
                batch['original_skel'][i],
                norm_preds[i],
                batch['camera_intrinsic'][i],
                batch['transform_opts'][i],
            )
            for i in range(len(norm_preds))
            if valid_depth[i] == 1
        ]

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, index):
        ...


def derive_epoch_rng(seed, epoch) -> np.random.RandomState:
    """The shared (seed, epoch) -> RandomState derivation for epoch-pinned
    sampler orders. Resume bit-reproducibility hinges on every sampler type
    using this ONE convention (RandomSampler here, RoundRobinSampler in
    data/mixed.py): a resumed run must regenerate exactly the order the
    uninterrupted run consumed."""
    derived = np.random.SeedSequence(
        [int(seed), int(epoch)]).generate_state(1)[0]
    return np.random.RandomState(derived)


class RandomSampler:
    """Uniform sampler with a fixed number of examples per epoch.

    Seeded samplers support ``iter_epoch(epoch)`` (used by the loader when
    its epoch is pinned via ``set_epoch``): the epoch's order is a pure
    function of (seed, epoch), so a ``resume=``d run consumes the SAME
    sample sequence an uninterrupted run would — plain ``iter`` draws from a
    persistent stream, which restarts from epoch 0's order after a resume.
    """

    def __init__(self, total_length, examples_per_epoch=None, seed=None):
        self.total_length = total_length
        self.examples_per_epoch = examples_per_epoch or total_length
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.examples_per_epoch

    def _draw(self, rng):
        n, total = self.examples_per_epoch, self.total_length
        if n > total:
            yield from rng.randint(0, total, size=n).tolist()
        else:
            yield from rng.permutation(total)[:n].tolist()

    def __iter__(self):
        return self._draw(self.rng)

    def iter_epoch(self, epoch):
        if self.seed is None:
            return iter(self)
        return self._draw(derive_epoch_rng(self.seed, epoch))


class SequentialSampler:
    def __init__(self, total_length):
        self.total_length = total_length

    def __len__(self):
        return self.total_length

    def __iter__(self):
        return iter(range(self.total_length))


def collate(samples: list) -> dict:
    """Stack numpy-array fields; pass through cameras / dicts / scalars as
    lists (reference: src/margipose/data/__init__.py:157-186)."""
    if len(samples) == 0:
        return samples
    first = samples[0]
    if isinstance(first, np.ndarray):
        return np.stack(samples, axis=0)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(samples)
    if isinstance(first, CameraIntrinsics):
        return list(samples)
    if isinstance(first, dict):
        return {k: _collate_field([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return list(samples)
    return list(samples)


def _collate_field(values: list):
    first = values[0]
    if isinstance(first, np.ndarray):
        return np.stack(values, axis=0)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(values)
    return list(values)
