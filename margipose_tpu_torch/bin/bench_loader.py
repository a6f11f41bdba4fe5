#!/usr/bin/env python3
"""Benchmark host input-pipeline throughput under FULL mpi3d augmentation.

Counterpart of ``margipose_tpu/bin/bench_loader.py``. Measures how many
augmented 256x256 training examples per second the host loader produces
(JPEG decode -> background/clothing compositing -> affine warp + colour +
normalise) at several worker counts, on a procedural miniature dataset in
the processed on-disk layout (``data/fake_mpi3d.py``) unless
``--dataset-dir`` points at real data. It reads HDF5, so it needs h5py. It
prints the host's rates and nothing else: what the card's train step
consumes is measured on the card (``chip_smoke.py``).

Usage:  python -m margipose_tpu_torch.bin.bench_loader [--seconds 20] [--workers 0,2,4]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--dataset-dir', default=None,
                        help='processed mpi3d dir (default: generate fake)')
    parser.add_argument('--seconds', type=float, default=20.0)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--workers', default='0,2,4',
                        help='comma-separated worker counts to test')
    args = parser.parse_args(argv)

    from margipose_tpu_torch.data.loader import make_dataloader
    from margipose_tpu_torch.data.mpi_inf_3dhp import MpiInf3dDataset
    from margipose_tpu_torch.data.specs import DataSpecs, ImageSpecs, JointsSpecs
    from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc

    tmp = None
    data_dir = args.dataset_dir
    if data_dir is None:
        from margipose_tpu_torch.data.fake_mpi3d import generate_fake_mpi3d

        tmp = tempfile.TemporaryDirectory(prefix='fake_mpi3d_')
        # S2/Seq2 + S3/Seq2 are fully bg/ub/lb-augmentable
        data_dir = generate_fake_mpi3d(
            tmp.name, seqs=((2, 2), (3, 2)), camera_ids=(0, 2, 5),
            n_frames=6)
        print(f'generated fake mpi3d at {data_dir}')

    try:
        specs = DataSpecs(ImageSpecs(256), JointsSpecs(CanonicalSkeletonDesc, n_dims=3))
        dataset = MpiInf3dDataset(data_dir, data_specs=specs, use_aug=True, seed=0)
        print(f'{len(dataset)} frames, full augmentation '
              f'(compositing + affine warp + colour), host cores: '
              f'{len(os.sched_getaffinity(0))}')

        results = {}
        for nw in [int(w) for w in args.workers.split(',')]:
            sampler = dataset.sampler(examples_per_epoch=4096, seed=0)
            loader = make_dataloader(dataset, batch_size=args.batch_size,
                                     sampler=sampler, drop_last=True,
                                     num_workers=nw)

            def batches():  # loop epochs so the clock decides when to stop
                while True:
                    yield from iter(loader)

            it = batches()
            next(it)  # warm caches / open files
            n_images = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                batch = next(it)
                n_images += len(batch['valid_depth'])
            dt = time.perf_counter() - t0
            results[nw] = n_images / dt
            print(f'workers={nw}: {n_images / dt:.1f} images/sec host-side')

        best = max(results.values())
        print(f'\nbest: {best:.1f} images/sec on this host '
              f'({len(os.sched_getaffinity(0))} cores)')
    finally:
        if tmp is not None:
            tmp.cleanup()
    return results


if __name__ == '__main__':
    main()
