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
    # On-device augmentation: when ``device_aug`` is set, samples carry the
    # raw uint8 frame + the composed affine + colour params instead of a
    # host-warped 'input'; the trainer applies ops.image.device_augment to
    # the whole batch on the device. Variable-size sources (mpii, h36m) are
    # letterboxed onto the fixed ``device_aug_canvas`` with the placement
    # scale folded into the affine, so every dataset in a mixed recipe
    # ships one static raw shape.
    device_aug = False
    raw_size = None  # (height, width) of raw frames, when fixed
    device_aug_canvas = None  # (height, width) raw canvas; set by the
    #                           loader factory (train/helpers.py); defaults
    #                           to raw_size for fixed-size sources
    device_aug_crop = False  # crop-ship mode: ship only the affine's
    #                          source region letterboxed onto the canvas

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

    def device_aug_fields(self, ctx: "TransformerContext", orig_image) -> dict:
        """Sample fields for the on-device augmentation path.

        Two shipping modes, chosen by the loader factory:

        * **full-frame** (``device_aug_crop`` False): frames matching the
          canvas pass through untouched (the mpi3d 768px case). Smaller
          frames are zero-padded top-left — exact: the pad pixels are the
          same zeros the host warp's out-of-bounds fill produces. Larger
          frames are bilinearly downscaled to fit (aspect preserved).
        * **crop-ship** (``device_aug_crop`` True): the device warp only
          samples the affine's source region (the crop around the person),
          so the loader crops the frame to that bbox (a memcpy — no
          resample) and letterboxes the crop onto a SMALL canvas. Shipped
          bytes drop from frame-size to canvas-size uint8 — below even the
          host-aug path's warped float32 — which matters at host-to-device
          copy rates.

        In both modes every geometric placement (crop offset, letterbox
        scale) is folded into the shipped affine: with ``out = A @ orig``,
        a crop at offset t gives ``orig = crop + t``, and a letterbox scale
        S gives ``crop = S^-1 @ canvas``, so ``A' = A @ T(t) @ S^-1`` and
        the device warp is unchanged. Downscale (when the source region
        exceeds the canvas) costs one extra resample versus the host path
        (full aug pipeline reference: src/margipose/data/__init__.py:97-108;
        variable-size MPII sources
        reference: src/margipose/data/mpii/__init__.py:170-198).
        """
        arr = as_rgb_array(orig_image)
        canvas = self.device_aug_canvas or self.raw_size
        assert canvas is not None, (
            'device_aug needs device_aug_canvas (set by the loader factory) '
            'or a fixed raw_size')
        ch, cw = canvas
        affine = np.eye(3, dtype=np.float32)
        a = np.asarray(ctx.affine, np.float32)
        affine[:a.shape[0]] = a

        if getattr(self, 'device_aug_crop', False):
            arr, affine = _crop_to_affine_source(
                arr, affine, ctx.opts['out_width'], ctx.opts['out_height'])

        h, w = arr.shape[:2]
        if (h, w) != (ch, cw):
            sx = sy = 1.0
            if h > ch or w > cw:
                import PIL.Image

                s = min(ch / h, cw / w)
                nh = max(1, int(round(h * s)))
                nw = max(1, int(round(w * s)))
                arr = np.asarray(PIL.Image.fromarray(arr).resize(
                    (nw, nh), PIL.Image.BILINEAR))
                sx, sy = nw / w, nh / h
            padded = np.zeros((ch, cw, 3), np.uint8)
            padded[:arr.shape[0], :arr.shape[1]] = arr
            arr = padded
            if sx != 1.0 or sy != 1.0:
                affine = (affine @ np.diag([1.0 / sx, 1.0 / sy, 1.0])
                          ).astype(np.float32)
        o = ctx.opts
        colour = np.asarray([o.get('brightness', 1.0), o.get('contrast', 1.0),
                             o.get('saturation', 1.0), o.get('hue', 0.0)],
                            np.float32)
        return {'raw_image': np.ascontiguousarray(arr),
                'aug_affine': affine, 'aug_colour': colour}

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


def _crop_to_affine_source(arr, affine, out_width, out_height, margin=2):
    """Crop ``arr`` to the region the inverse affine samples, folding the
    crop offset into the affine.

    The output square's corners map through A^-1 to the source quad; its
    bbox (plus a bilinear margin, clipped to the frame) bounds every pixel
    the warp can read. Returns (cropped array, updated 3x3 affine).
    """
    inv = np.linalg.inv(affine.astype(np.float64))
    corners = np.array([[0.0, 0.0, 1.0], [out_width, 0.0, 1.0],
                        [0.0, out_height, 1.0], [out_width, out_height, 1.0]])
    src = corners @ inv.T  # affine: homogeneous w stays 1
    xs, ys = src[:, 0], src[:, 1]
    h, w = arr.shape[:2]
    x0 = int(np.clip(np.floor(xs.min()) - margin, 0, max(w - 1, 0)))
    y0 = int(np.clip(np.floor(ys.min()) - margin, 0, max(h - 1, 0)))
    x1 = int(np.clip(np.ceil(xs.max()) + margin, x0 + 1, w))
    y1 = int(np.clip(np.ceil(ys.max()) + margin, y0 + 1, h))
    cropped = arr[y0:y1, x0:x1]
    # orig = crop + (x0, y0)  =>  A' = A @ T(x0, y0)
    t = np.eye(3, dtype=np.float64)
    t[0, 2], t[1, 2] = x0, y0
    return cropped, (affine.astype(np.float64) @ t).astype(np.float32)


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
