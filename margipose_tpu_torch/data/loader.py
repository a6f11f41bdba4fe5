"""Batched data loading with threaded workers and device prefetch.

Replaces the reference's multi-process torch DataLoader
(reference: src/margipose/data/__init__.py:193-232) with a thread-pool
pipeline producing fixed-shape NHWC numpy batches. The eval bin
(``margipose_tpu_torch.bin.eval_3d``) uploads them to the device.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

from margipose_tpu_torch.data.base import SequentialSampler, collate, set_aug_ordinal

class DataLoader:
    def __init__(self, dataset, batch_size=1, sampler=None, drop_last=False,
                 num_workers=0, prefetch_batches=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else SequentialSampler(len(dataset))
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Pin the epoch used in per-example augmentation ordinals (like
        torch's DistributedSampler.set_epoch). Without calls, epochs
        auto-increment per ``__iter__``; training loops that resume should
        call this so augmentation draws line up with an uninterrupted run."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, epoch):
        """Yields (chunk, positions): sampler indices for one batch plus
        their positions in the epoch's sample sequence. Positions feed the
        per-example augmentation ordinals (base.set_aug_ordinal), making aug
        draws a function of sampler position rather than thread timing.
        Seeded samplers expose ``iter_epoch``, pinning the epoch's ORDER to
        (seed, epoch) as well, so resume= training replays the exact sample
        sequence of an uninterrupted run."""
        if hasattr(self.sampler, 'iter_epoch'):
            it = self.sampler.iter_epoch(epoch)
        else:
            it = iter(self.sampler)
        pos = 0
        while True:
            chunk = list(itertools.islice(it, self.batch_size))
            if not chunk:
                return
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk, range(pos, pos + len(chunk))
            pos += len(chunk)

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1  # auto-advance; set_epoch overrides

        def load_one(pos_idx):
            pos, idx = pos_idx
            set_aug_ordinal((epoch, pos))
            try:
                return self.dataset[idx]
            finally:
                set_aug_ordinal(None)

        if self.num_workers <= 0:
            for chunk, positions in self._index_batches(epoch):
                yield collate([load_one(pi) for pi in zip(positions, chunk)])
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def load_batch(chunk_positions):
                chunk, positions = chunk_positions
                return collate(list(pool.map(load_one, zip(positions, chunk))))

            pending = []
            batches = self._index_batches(epoch)
            # Keep up to prefetch_batches batch-futures in flight.
            submit = ThreadPoolExecutor(max_workers=self.prefetch_batches)
            try:
                for chunk in itertools.islice(batches, self.prefetch_batches):
                    pending.append(submit.submit(load_batch, chunk))
                for chunk in batches:
                    out = pending.pop(0).result()
                    pending.append(submit.submit(load_batch, chunk))
                    yield out
                for fut in pending:
                    yield fut.result()
            finally:
                submit.shutdown(wait=False, cancel_futures=True)


class UnbatchedDataLoader:
    """Loader where each dataset item is itself a (multicrop) batch
    (reference: src/margipose/data/__init__.py:202-232).

    With ``num_workers`` > 0 upcoming items are loaded ahead in a thread
    pool (decode + 10-crop assembly release the GIL in PIL/numpy
    code), overlapping host item preparation with device inference instead
    of serialising them — the reference's multicrop path is likewise
    num_workers-driven via torch's DataLoader. Items are yielded strictly
    in dataset order either way.
    """

    def __init__(self, dataset, num_workers=0, prefetch_items=4):
        self.dataset = dataset
        self.num_workers = num_workers
        self.prefetch_items = max(prefetch_items, 1)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        if self.num_workers <= 0:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            indices = iter(range(len(self.dataset)))
            try:
                for i in itertools.islice(indices, self.prefetch_items):
                    pending.append(pool.submit(self.dataset.__getitem__, i))
                for i in indices:
                    out = pending.pop(0).result()
                    pending.append(pool.submit(self.dataset.__getitem__, i))
                    yield out
                for fut in pending:
                    yield fut.result()
            finally:
                for fut in pending:
                    fut.cancel()


def make_dataloader(dataset, batch_size=1, sampler=None, drop_last=False,
                    num_workers=0):
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      drop_last=drop_last, num_workers=num_workers)


def make_unbatched_dataloader(dataset, num_workers=0):
    return UnbatchedDataLoader(dataset, num_workers=num_workers)
