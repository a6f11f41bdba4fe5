"""The traced window: ``torch.profiler`` (CPU and CUDA activities) around a
stretch of the cell's own traffic, reduced to what the per-layer metrics
read.

The window is the span of a ``bench.window`` annotation that ends after a
``torch.cuda.synchronize()``, in the trace's own clock. Busy time is the
union of the device's activity (kernels, copies, fills; not the shadows that
host annotations cast on the device's timeline) inside it; an idle
gap is a stretch of it with none, named by what the host was doing at its
middle: the benchmark's own annotation (``bench.*``) and the outermost
``aten::`` operator there. Reduction reads the profiler's raw events, not
``key_averages``, so that a window of a few hundred thousand events reduces
in seconds.
"""

import bisect
import contextlib
import time

import torch

WINDOW = 'bench.window'
TOP = 10


def _ns(event, what):
    if what == 'start':
        return event.start_ns() if hasattr(event, 'start_ns') else event.start_us() * 1000
    return event.duration_ns() if hasattr(event, 'duration_ns') else event.duration_us() * 1000


def _outermost(spans):
    """The spans (start, end, name) not inside an earlier one, sorted."""
    out = []
    for s in sorted(spans):
        if not out or s[0] >= out[-1][1]:
            out.append(s)
    return out


def _at(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] > t:
        return spans[i][2]
    return None


def reduce(events):
    """The trace's numbers: ``window_s``, ``busy_s``, ``kernels`` {name:
    [launches, seconds]}, ``device_ops`` and ``idle_gaps`` (the top ten by
    seconds), ``launches`` (kernels in the window)."""
    window = None
    device, annotations, ops, host_names = [], [], [], set()
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
    if window is None:
        raise RuntimeError(f'the trace holds no {WINDOW} annotation')
    # a host annotation (record_function: the benchmark's, DDP's, NCCL's)
    # casts a shadow of its name over the device's timeline: no activity
    device = [d for d in device if d[2] not in host_names]
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1)
    kernels = {}
    for s, e, n in device:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    busy, gaps, cursor = 0, [], w0
    for s, e, _ in device:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    annotations, ops = _outermost(annotations), _outermost(ops)
    a_starts, o_starts = [a[0] for a in annotations], [o[0] for o in ops]
    idle = {}
    for s, e in gaps:
        mid = (s + e) // 2
        label = ' > '.join(x for x in (_at(annotations, a_starts, mid), _at(ops, o_starts, mid))
                           if x) or 'no host operator'
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    launches = sum(v[0] for n, v in kernels.items() if not n.startswith(('Memcpy', 'Memset')))
    return {
        'window_s': (w1 - w0) / 1e9,
        'busy_s': busy / 1e9,
        'kernels': kernels,
        'launches': launches,
        'device_ops': sorted(([n[:160], v[1]] for n, v in kernels.items()),
                             key=lambda x: -x[1])[:TOP],
        'idle_gaps': sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1])[:TOP],
    }


@contextlib.contextmanager
def profiled(device):
    """Profile the body as the traced window; yields a dict that holds the
    reduction (``reduce``) and ``reduce_s`` once the body has run."""
    out = {}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out.update(reduce(prof.profiler.kineto_results.events()))
    out['reduce_s'] = time.perf_counter() - t0


def span(name, traced):
    """An annotation of the benchmark's own around a call into a layer, in a
    traced window; nothing otherwise."""
    return torch.profiler.record_function(f'bench.{name}') if traced else contextlib.nullcontext()
