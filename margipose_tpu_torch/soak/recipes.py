"""The two soak recipes as ``bin/train_3d`` config words.

``full-schedule`` is ``scripts/soak_full_schedule.sh``: the whole 150-epoch
1cycle schedule (reference: src/margipose/hyperparam_scheduler.py:6-21),
including the final tenth's anneal to lr_max/1e4 and the momentum's return,
at miniature scale: MargiPose v6.0.1 at 2 stages with the resnet18 stem at
128 px, batch 8 x 64 examples an epoch, lr 0.2, device augmentation with
crop-ship onto a 192 px canvas, a checkpoint every epoch. ``chatterbox`` is
``scripts/soak_chatterbox.sh``: Chatterbox (256 px only: its head's geometry
fixes 32x32 heatmaps) for 6 epochs x 320 examples at batch 16 and lr 0.1
with host augmentation, then an eval of the saved checkpoint.

Each recipe runs on the ``fake`` corpus (``soak/corpus.py``, as the shell
scripts do; it needs ``h5py``) or on ``synthetic``, which needs no files
and supports device augmentation, with every other setting the same.
"""

from __future__ import annotations

import dataclasses

FULL_SCHEDULE_DESC = {'type': 'margipose', 'version': '6.0.1',
                      'settings': {'n_stages': 2, 'axis_permutation': True,
                                   'feature_extractor': 'resnet18', 'pixelwise_loss': 'jsd',
                                   'input_size': 128}}
DATASETS = ('synthetic', 'fake')
EVAL_BATCH_SIZE = 4  # the Chatterbox script's eval batch


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A soak: ``words`` of ``bin/train_3d`` after ``with``, and the
    training sets and the eval set of each dataset kind."""

    name: str
    experiment_id: str
    words: tuple
    train_datasets: dict
    eval_dataset: dict

    def train_words(self, dataset: str, out_dir: str, overrides=()) -> list:
        """The config words of a run on ``dataset`` into ``out_dir``;
        ``overrides`` (``key=value`` words) come last, so they win."""
        if dataset not in DATASETS:
            raise ValueError(f'dataset {dataset!r}; expected one of {DATASETS}')
        return [*self.words, f'train_datasets={self.train_datasets[dataset]!r}',
                f'experiment_id={self.experiment_id}', f'out_dir={out_dir}', *overrides]


RECIPES = {r.name: r for r in (
    Recipe('full-schedule', 'soak150',
           ('margipose_model', '1cycle', f'model_desc={FULL_SCHEDULE_DESC!r}', 'epochs=150',
            'batch_size=8', 'train_examples=64', 'val_examples=0', 'val_datasets=[]', 'lr=0.2',
            'num_workers=2', 'metrics_every=4', 'checkpoint_every=1', 'device_aug=True',
            'device_aug_canvas=192', 'use_aug=True'),
           {'fake': ['mpi3d-trainval', 'mpii-trainval'], 'synthetic': ['synthetic-512']},
           {'fake': 'mpi3d-val', 'synthetic': 'synthetic-32@1'}),
    Recipe('chatterbox', 'soakcb',
           ('chatterbox_model', '1cycle', 'epochs=6', 'batch_size=16', 'train_examples=320',
            'val_examples=0', 'val_datasets=[]', 'lr=0.1', 'num_workers=2', 'metrics_every=4',
            'checkpoint_every=1', 'use_aug=True'),
           {'fake': ['mpi3d-train'], 'synthetic': ['synthetic-512']},
           {'fake': 'mpi3d-val', 'synthetic': 'synthetic-32@1'}),
)}
