"""Faults planted under the timed path, to show that a run which carries one
comes out not correct: ``python -m benchmark.tools.readings --fault NAME``
on the chip, and ``tests/test_bench_faults.py`` on the CPU.

  * ``unchanged``: the train step returns its state unchanged (no update);
  * ``half_batch``: half of each batch left out; the train step and the
    eval forward take the mean over the rest, and each left-out row's
    answer is a kept row's;
  * ``altered``: one answer of each batch altered where it is produced (its
    first joint's x moved by 2, out of the frame);
  * ``no_exchange``: the exchange between cards left out: no all-reduce of
    the batch norms' statistics or the loss, and no DistributedDataParallel
    averaging of the gradients.

Each is a context manager that patches the port's module the driver reads
the function from, at the time the driver reads it.
"""

import contextlib

import numpy as np

ALTERATION = 2.0


def _halve(t):
    return t[:max(len(t) // 2, 1)]


def _refill(half, n):
    """``n`` rows: ``half``'s, then its first rows again."""
    parts = [half] * -(-n // len(half))
    if isinstance(half, np.ndarray):
        return np.concatenate(parts)[:n]
    import torch

    return torch.cat(parts)[:n]


@contextlib.contextmanager
def planted(name):
    import margipose_tpu_torch.bin.eval_3d as eval_3d
    import margipose_tpu_torch.bin.serve as serve
    import margipose_tpu_torch.parallel.mesh as mesh
    import margipose_tpu_torch.train.steps as steps

    if name == 'no_exchange':
        saved = (mesh.all_reduce_sum, steps.DistributedDataParallel)
        mesh.all_reduce_sum = lambda tensor, group=None: tensor
        steps.DistributedDataParallel = lambda module, **kwargs: module
        try:
            yield
        finally:
            mesh.all_reduce_sum, steps.DistributedDataParallel = saved
        return
    saved = (steps.make_train_step, eval_3d.make_forward, serve.model_runner)
    make_train_step, make_forward, model_runner = saved

    def train_step_(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def broken(state, batch):
            if name == 'unchanged':
                update, state.optimiser.step = state.optimiser.step, lambda: None
                try:
                    return step(state, batch)
                finally:
                    state.optimiser.step = update
            out = step(state, {k: _halve(v) for k, v in batch.items()})
            return dict(out, pred=_refill(out['pred'], len(batch['input'])))

        return broken

    def forward_(*args, **kwargs):
        forward = make_forward(*args, **kwargs)

        def broken(images, target, mask, depth):
            if name == 'half_batch':
                xyz, loss = forward(*(_halve(t) for t in (images, target, mask, depth)))
                return _refill(xyz, len(images)), loss
            xyz, loss = forward(images, target, mask, depth)
            xyz = xyz.clone()
            xyz[0, 0, 0] += ALTERATION
            return xyz, loss

        return broken

    def runner_(*args, **kwargs):
        runner = model_runner(*args, **kwargs)

        def broken(batch):
            if name == 'half_batch':
                return _refill(runner(_halve(batch)), len(batch))
            out = runner(batch).copy()
            out[0, 0, 0] += ALTERATION
            return out

        return broken

    steps.make_train_step, eval_3d.make_forward, serve.model_runner = (
        train_step_, forward_, runner_)
    try:
        yield
    finally:
        steps.make_train_step, eval_3d.make_forward, serve.model_runner = saved
