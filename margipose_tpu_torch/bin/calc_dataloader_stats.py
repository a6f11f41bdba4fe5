#!/usr/bin/env python3
"""Sanity-check histograms of target-coordinate and pixel distributions from
the train dataloader.

Counterpart of ``margipose_tpu/bin/calc_dataloader_stats.py`` (reference:
src/margipose/bin/calc_dataloader_stats.py), over the port's datasets and
loader, which give the JAX package's batches: it streams batches,
accumulates histograms, and writes a PNG panel and printed summary stats
instead of a live matplotlib animation. Host only: no device runs.

    python -m margipose_tpu_torch.bin.calc_dataloader_stats --dataset synthetic-64
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from margipose_tpu_torch.data.get_dataset import get_dataset
from margipose_tpu_torch.data.loader import DataLoader
from margipose_tpu_torch.models import default_data_specs
from margipose_tpu_torch.utils import seed_all


# Reference flag spellings accepted as-is. Normalised on argv BEFORE parsing
# (rather than registered as argparse aliases) so that prefix abbreviations
# of the primary spellings keep working: an alias option string on the same
# action would make e.g. '--out' ambiguous between --out-file and --output.
_REFERENCE_FLAG_ALIASES = {
    '--output': '--out-file',
    '--examples-per-epoch': '--examples',
}


def _normalize_argv(argv):
    out = []
    for tok in argv:
        if tok.startswith('--') and '=' in tok:
            head, _, rest = tok.partition('=')
            out.append(_REFERENCE_FLAG_ALIASES.get(head, head) + '=' + rest)
        else:
            out.append(_REFERENCE_FLAG_ALIASES.get(tok, tok))
    return out


def parse_args(argv):
    parser = argparse.ArgumentParser(description='dataloader statistics')
    parser.add_argument('--dataset', type=str, default='mpi3d-train')
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--examples', type=int, default=512,
                        help='examples to draw per epoch (the reference '
                             'spelling --examples-per-epoch is accepted)')
    parser.add_argument('--epochs', type=int, default=1,
                        help='passes through the sampled examples '
                             '(reference: calc_dataloader_stats.py --epochs)')
    parser.add_argument('--use-aug', action='store_true')
    parser.add_argument('--without-image', action='store_true',
                        help='skip image loading (geometry path only)')
    parser.add_argument('--with-image', action='store_false',
                        dest='without_image',
                        help='load images (the default here; accepted for '
                             'reference CLI compatibility)')
    parser.add_argument('--out-file', type=str,
                        default='dataloader_stats.png',
                        help='figure path (the reference spelling --output '
                             'is accepted)')
    return parser.parse_args(_normalize_argv(argv[1:]))


class StatTracker:
    """Streaming histogram accumulator
    (reference: calc_dataloader_stats.py:38-67)."""

    def __init__(self, bins, lo, hi):
        self.bins = bins
        self.lo = lo
        self.hi = hi
        self.counts = np.zeros(bins, dtype=np.int64)
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0

    def add(self, values):
        values = np.asarray(values).reshape(-1)
        hist, _ = np.histogram(values, bins=self.bins, range=(self.lo, self.hi))
        self.counts += hist
        self.n += values.size
        self.sum += float(values.sum())
        self.sum_sq += float((values ** 2).sum())

    @property
    def mean(self):
        return self.sum / max(self.n, 1)

    @property
    def std(self):
        m = self.mean
        return float(np.sqrt(max(self.sum_sq / max(self.n, 1) - m * m, 0)))


def main(argv=None):
    args = parse_args(argv or sys.argv)
    seed_all(12345)

    dataset = get_dataset(args.dataset, default_data_specs(), use_aug=args.use_aug)
    if args.without_image and hasattr(dataset, 'without_image'):
        dataset.without_image = True

    loader = DataLoader(
        dataset, batch_size=args.batch_size,
        sampler=dataset.sampler(args.examples), num_workers=2)

    trackers = {
        'target_x': StatTracker(41, -1.2, 1.2),
        'target_y': StatTracker(41, -1.2, 1.2),
        'target_z': StatTracker(41, -1.2, 1.2),
    }
    if not args.without_image:
        trackers['pixels'] = StatTracker(41, -3, 3)

    # range(epochs) exactly: --epochs 0 does zero passes, like the
    # reference's `for epoch in range(opts.epochs)` loop
    for _ in range(args.epochs):
        for batch in loader:
            target = np.asarray(batch['target'])
            trackers['target_x'].add(target[..., 0])
            trackers['target_y'].add(target[..., 1])
            trackers['target_z'].add(target[..., 2])
            if 'pixels' in trackers and 'input' in batch:
                trackers['pixels'].add(np.asarray(batch['input']))

    for name, t in trackers.items():
        print(f'{name:10s} mean={t.mean:+.4f} std={t.std:.4f} n={t.n}')

    try:
        import matplotlib

        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, len(trackers), figsize=(5 * len(trackers), 4))
        for ax, (name, t) in zip(np.atleast_1d(axes), trackers.items()):
            edges = np.linspace(t.lo, t.hi, t.bins + 1)
            ax.bar(edges[:-1], t.counts, width=np.diff(edges), align='edge')
            ax.set_title(name)
        fig.tight_layout()
        fig.savefig(args.out_file, dpi=100)
        print(f'wrote {args.out_file}')
    except Exception as e:
        print(f'plotting skipped: {e}')


if __name__ == '__main__':
    main()
