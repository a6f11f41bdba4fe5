"""Spans inside the train step: the host time of each of its phases.

    from margipose_tpu_torch import tracing

    tracing.enable()
    for batch in batches:
        train_step(state, batch)
    torch.cuda.synchronize()
    spans = tracing.take()    # [Span(name, parent, start_ns, end_ns, step), ...]
    tracing.disable()

``train/steps.make_train_step`` records one ``train.step`` span a step with
four children, in this order: ``train.forward`` (the model's call),
``train.loss`` (the masked loss: the loss head's forward kernel and the
masked mean), ``train.backward`` (``loss.backward()``, and on a hybrid mesh
the replicated gradients' average) and ``train.update`` (the schedule and
the optimiser's step). Zeroing the gradients, the mode switch, the
DistributedDataParallel wrapper and the step counter are ``train.step``'s
own time. A step replayed from a CUDA graph records ``train.replay`` (the
schedule's fills, the batch's copies into the graph and the replay) under
``train.step`` in place of the four phases; the step that captures the
graph records ``train.capture``, holding the four phases as they were
recorded, then ``train.replay``. A span's ``step`` is the train state's
``step`` as the step began: the spans of one step share it, and ``parent``
is the index in the same ``take()`` of the span that encloses it.

The times are the host's (``time.perf_counter_ns``): a span ends when the
host has queued its work, not when the device has run it, so time the
phases with the profiler off. To see them on the device's timeline, run the
steps under ``torch.profiler`` as well: while the profiler is on, each span
also opens a ``torch.profiler.record_function`` of its name, so the phases
sit in the trace's own clock beside the ``aten::`` operators and the
device's kernels.

Off, the default, a span costs one flag check: ``span`` returns one shared
null context and touches neither torch nor the clock. On, the spans of the
step's thread are kept in memory, at most ``LIMIT`` between two ``take()``s;
past that none is kept until the next ``take()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SPANS = ('train.step', 'train.forward', 'train.loss', 'train.backward', 'train.update')
# a graphed step's spans; apart from SPANS, whose phases (all but the first)
# every eager step records and benchmark/spans.py reads as such
GRAPH_SPANS = ('train.capture', 'train.replay')
# the CUDA runtime's and driver's host events that launch device work, as
# torch.profiler names them (prefixes): what a span's launches are counted by
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaGraphLaunch')
LIMIT = 50_000  # 10,000 steps of five spans

_NULL = contextlib.nullcontext()
_on = False
_spans: list[Span] = []
_open: list[int | None] = []  # the spans entered and not yet left: indices in _spans


@dataclasses.dataclass(slots=True)
class Span:
    """A recorded span: ``parent`` is the index of the enclosing span in the
    same ``take()`` (None at the top), ``end_ns`` None while it is open."""

    name: str
    parent: int | None
    start_ns: int
    end_ns: int | None
    step: int | None


class _Recording:
    __slots__ = ('name', 'step', 'index', 'annotation')

    def __init__(self, name, step):
        self.name, self.step, self.index, self.annotation = name, step, None, None

    def __enter__(self):
        parent = _open[-1] if _open else None
        # a span whose parent was not kept is not kept either
        if len(_spans) < LIMIT and (parent is not None or not _open):
            step = self.step if self.step is not None or parent is None else _spans[parent].step
            self.index = len(_spans)
            _spans.append(Span(self.name, parent, 0, None, step))
        _open.append(self.index)
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.index is not None:
            _spans[self.index].start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _open.pop()
        if self.index is not None:
            _spans[self.index].end_ns = end
        return False


def span(name, step=None):
    """A context manager that records the span ``name`` (one of ``SPANS`` or
    ``GRAPH_SPANS``) while tracing is on; ``step`` (None: the enclosing
    span's) identifies the train step it belongs to."""
    if not _on:
        return _NULL
    if name not in SPANS + GRAPH_SPANS:
        raise ValueError(f'{name!r} is not one of the recorded spans {SPANS + GRAPH_SPANS}')
    return _Recording(name, step)


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def take():
    """The spans recorded since the last ``take()``, in the order they
    began; the recorder keeps none of them. Call it between steps."""
    global _spans
    if _open:
        raise RuntimeError(f'take() inside an open span ({len(_open)} open): call it '
                           'between steps')
    out, _spans = _spans, []
    return out
