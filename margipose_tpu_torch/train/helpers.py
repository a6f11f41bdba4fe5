"""Training helper factories.

Counterpart of ``margipose_tpu/train/helpers.py:13-104`` (reference:
src/margipose/train_helpers.py:15-105), without the on-device augmentation
branch: several datasets per loader go through ``MixedPoseDataset``, each
with its own augmentation seed.
"""

from __future__ import annotations

import numpy as np

from margipose_tpu_torch.data.get_dataset import get_dataset
from margipose_tpu_torch.data.loader import DataLoader
from margipose_tpu_torch.data.mixed import MixedPoseDataset
from margipose_tpu_torch.utils import draw_skeleton_2d


def _create_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                       use_aug, num_workers=4, seed=None):
    datasets = [
        get_dataset(name, data_specs, use_aug=use_aug,
                    # distinct per-source aug streams, derived from the one
                    # loader seed (reproducible; see PoseDataset.example_rng)
                    seed=None if seed is None else seed + 7919 * i)
        for i, name in enumerate(dataset_names)
    ]
    if not datasets:
        raise ValueError('at least one dataset must be specified')
    dataset = datasets[0] if len(datasets) == 1 else MixedPoseDataset(datasets)
    return DataLoader(
        dataset,
        sampler=dataset.sampler(examples_per_epoch=examples_per_epoch, seed=seed),
        batch_size=batch_size,
        drop_last=True,
        num_workers=num_workers,
    )


def create_train_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                            use_aug=True, num_workers=4, seed=None):
    return _create_dataloader(dataset_names, data_specs, batch_size, examples_per_epoch,
                              use_aug, num_workers, seed)


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
