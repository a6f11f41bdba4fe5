"""Training helper factories.

Counterpart of ``margipose_tpu/train/helpers.py:13-104`` (reference:
src/margipose/train_helpers.py:15-105): several datasets per loader go
through ``MixedPoseDataset``, each with its own augmentation seed, and
``device_aug`` picks the one raw canvas the whole recipe ships.
"""

from __future__ import annotations

import numpy as np

from margipose_tpu_torch.data.get_dataset import get_dataset
from margipose_tpu_torch.data.loader import DataLoader
from margipose_tpu_torch.data.mixed import MixedPoseDataset
from margipose_tpu_torch.utils import draw_skeleton_2d


def _create_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                       use_aug, num_workers=4, seed=None, device_aug=False,
                       device_aug_canvas=0):
    datasets = [
        get_dataset(name, data_specs, use_aug=use_aug,
                    # distinct per-source aug streams, derived from the one
                    # loader seed (reproducible; see PoseDataset.example_rng)
                    seed=None if seed is None else seed + 7919 * i)
        for i, name in enumerate(dataset_names)
    ]
    if not datasets:
        raise ValueError('at least one dataset must be specified')
    if device_aug:
        # One static raw canvas for the whole (possibly mixed) recipe.
        #
        # device_aug_canvas > 0 selects CROP-SHIP mode: each example ships
        # only the affine's source region letterboxed onto an NxN canvas
        # (PoseDataset.device_aug_fields), cutting host->device bytes below
        # even the host-aug path's warped float32.
        #
        # device_aug_canvas == 0 ships FULL frames: fixed-size sources
        # (mpi3d 768px, synthetic) dictate the canvas and pass through
        # pixel-exact; variable-size sources (mpii, h36m) are letterboxed
        # onto it. 768px default matches the preprocessed mpi3d frame size
        # when no source is fixed.
        if device_aug_canvas:
            canvas = (int(device_aug_canvas), int(device_aug_canvas))
        else:
            fixed = [d.raw_size for d in datasets if d.raw_size is not None]
            if fixed:
                canvas = (max(s[0] for s in fixed), max(s[1] for s in fixed))
            else:
                canvas = (768, 768)
        for d in datasets:
            d.device_aug = True
            d.device_aug_canvas = canvas
            d.device_aug_crop = bool(device_aug_canvas)
    dataset = datasets[0] if len(datasets) == 1 else MixedPoseDataset(datasets)
    return DataLoader(
        dataset,
        sampler=dataset.sampler(examples_per_epoch=examples_per_epoch, seed=seed),
        batch_size=batch_size,
        drop_last=True,
        num_workers=num_workers,
    )


def create_train_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                            use_aug=True, num_workers=4, seed=None,
                            device_aug=False, device_aug_canvas=0):
    return _create_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                              use_aug, num_workers, seed, device_aug=device_aug,
                              device_aug_canvas=device_aug_canvas)


def create_val_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                          num_workers=4, seed=None):
    return _create_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                              False, num_workers, seed)


def visualise_predictions(preds, batch, dataset, max_images=8):
    """Images with predicted skeletons overlaid
    (reference: src/margipose/train_helpers.py:15-35)."""
    preds = np.asarray(preds, dtype=np.float64)
    if preds.shape[-1] < 4:
        pad = np.ones(preds.shape[:-1] + (4 - preds.shape[-1],))
        preds = np.concatenate([preds, pad], axis=-1)
    images = []
    n = min(len(batch['input']), max_images)
    for i in range(n):
        img = dataset.input_to_pil_image(np.asarray(batch['input'][i]))
        camera_intrinsics = batch['camera_intrinsic'][i]
        skel2d = dataset.to_image_space(batch['index'][i], preds[i], camera_intrinsics)
        draw_skeleton_2d(img, skel2d, dataset.skeleton_desc)
        images.append(img)
    return images


def save_image_grid(images, out_file, per_row=4):
    import PIL.Image

    if not images:
        return
    w, h = images[0].size
    rows = (len(images) + per_row - 1) // per_row
    grid = PIL.Image.new('RGB', (w * per_row, h * rows))
    for i, img in enumerate(images):
        grid.paste(img, ((i % per_row) * w, (i // per_row) * h))
    grid.save(out_file)
