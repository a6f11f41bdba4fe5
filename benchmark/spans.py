"""The program's spans in the train cell (``margipose_tpu_torch.tracing``):
the host time of each phase of a step, and where a traced window's kernel
launches and idle gaps fall among the phases.

Host times come from steps run with tracing on and the profiler off
(``host_ms``, ``first_step_s``): the profiler inflates the host path. A
profiled stretch run with tracing on gives what the profiler cannot
distort (``attribute``): the CUDA runtime's launch events (``LAUNCHES``),
each counted once under the innermost program span whose interval holds its
start, and the idle gaps of ``trace.reduce`` labelled with the innermost
program span at their middle besides the benchmark's annotation and the
outermost ``aten::`` operator. Launches from the autograd engine's thread
fall in ``train.backward``, which holds the main thread meanwhile.
"""

import bisect
import statistics
import types

import torch

from benchmark.trace import WINDOW, _at, _ns, _outermost
from margipose_tpu_torch.tracing import LAUNCHES, SPANS

STEP, *PHASES = SPANS
SELF = 'train.step.self'
NONE = '(none)'


def _ms(span):
    return (span.end_ns - span.start_ns) / 1e6


def host_ms(spans):
    """{``train.step``, each phase, ``train.step.self``: the median over the
    complete steps of ``spans`` (``tracing.take()``) of its ms a step}; {}
    where no step is complete. A step's self time is its span less its
    children's."""
    children = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    rows = []
    for i, s in enumerate(spans):
        kids = children.get(i, [])
        if s.name != STEP or s.end_ns is None or any(k.end_ns is None for k in kids):
            continue
        row = {STEP: _ms(s), SELF: _ms(s) - sum(_ms(k) for k in kids)}
        for k in kids:
            row[k.name] = row.get(k.name, 0.0) + _ms(k)
        if all(p in row for p in PHASES):
            rows.append(row)
    return {name: statistics.median(r[name] for r in rows) for name in rows[0]} if rows else {}


def first_step_s(spans):
    """The first ``train.step`` span of ``spans``, s; None where there is none."""
    for s in spans:
        if s.name == STEP and s.end_ns is not None:
            return (s.end_ns - s.start_ns) / 1e9
    return None


class Nested:
    """Properly nested (start, end, name) spans: the innermost over a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.top, end = [], None
        for s, e, _ in self.spans:
            self.top.append(end is None or s >= end)
            if self.top[-1]:
                end = e

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            _, e, name = self.spans[i]
            if e > t:
                return name
            if self.top[i]:  # earlier trees end before this one began
                return None
            i -= 1
        return None


def parse(events):
    """The profiler's raw ``events`` sorted out: ``window`` (start, end) of
    the ``bench.window`` annotation, ``device`` activity (start, end, name)
    clipped to it without the shadows host annotations cast there,
    ``annotations`` (outermost ``bench.*``), ``ops`` (outermost ``aten::``),
    ``spans`` (the program's, ``Nested``) and ``launches`` (the runtime's
    launch events' starts in the window, sorted)."""
    window, device, host_names = None, [], set()
    annotations, ops, spans, launches = [], [], [], []
    for e in events:
        start = _ns(e, 'start')
        end = start + _ns(e, 'duration')
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((start, end, name))
            continue
        host_names.add(name)
        if name == WINDOW:
            window = (start, end)
        elif name.startswith('bench.'):
            annotations.append((start, end, name))
        elif name.startswith('aten::'):
            ops.append((start, end, name))
        elif name in SPANS:
            spans.append((start, end, name))
        elif name.startswith(LAUNCHES):
            launches.append(start)
    if window is None:
        raise RuntimeError(f'the trace holds no {WINDOW} annotation')
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device
                    if n not in host_names and e > w0 and s < w1)
    return types.SimpleNamespace(
        window=window, device=device, annotations=_outermost(annotations),
        ops=_outermost(ops), spans=Nested(spans),
        launches=sorted(t for t in launches if w0 <= t < w1))


def _gaps(parsed):
    """The window's stretches (start, end) with no device activity."""
    (w0, w1), out, cursor = parsed.window, [], parsed.window[0]
    for s, e, _ in parsed.device:
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        out.append((cursor, w1))
    return out


def attribute(events):
    """``span_launches`` {program span or ``(none)``: the window's launch
    events under it} and ``idle_gaps`` [[label, seconds], ...], every label
    by seconds, each ``bench.* > train.* > aten::*`` as far as the host was
    in them at the gap's middle."""
    p = parse(events)
    span_launches = {}
    for t in p.launches:
        name = p.spans.at(t) or NONE
        span_launches[name] = span_launches.get(name, 0) + 1
    a_starts, o_starts = [a[0] for a in p.annotations], [o[0] for o in p.ops]
    idle = {}
    for s, e in _gaps(p):
        mid = (s + e) // 2
        label = ' > '.join(x for x in (_at(p.annotations, a_starts, mid), p.spans.at(mid),
                                       _at(p.ops, o_starts, mid)) if x) or 'no host operator'
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    return {'span_launches': span_launches,
            'idle_gaps': sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1])}
