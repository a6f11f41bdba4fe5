"""The train cell's program spans on the chip, in one process: what the
span metrics read, the checks on them, and what tracing costs.

    python -m benchmark.tools.train_spans --seed N [--out FILE]

It sets up ``margipose-train-bf16-b32`` as its driver does, with tracing on
through the judged steps (the first ``train.step`` holds cuDNN's timed
search: ``first_step_s``). Then, in turn: the driver's window of
``BENCHMARK.json``'s ``run_seconds`` with tracing off; a span stretch of
``SPAN_STEPS`` steps with tracing on and no profiler (each phase's median
host ms a step, ``train.step``'s self time, and the stretch's own wall ms a
step between synchronizes); the driver's profiled stretch (``trace_steps``,
``bench.upload`` and ``bench.train_step`` around each step) with tracing
on, reduced by ``trace.reduce`` and ``spans.attribute``; ``PAIRS`` pairs of
``SLICE_SECONDS`` slices with tracing on and off in turn, alternating which
goes first (the paired difference in ms a step), then ``STEP_PAIRS`` pairs
of single steps the same way (their host times); last, a span timed on the
host, off and on. One JSON line on standard output, appended to ``--out``;
the exit code is 1 where one of ``checks`` fails.
"""

import argparse
import contextlib
import json
import statistics
import time

from benchmark import common, run, spans, trace, traffic, weights
from benchmark.trace import _at

CELL = 'margipose-train-bf16-b32'
SPAN_STEPS = 20
PAIRS = 10
SLICE_SECONDS = 4.0
STEP_PAIRS = 100


def _quartiles(values):
    q = statistics.quantiles(values, n=4)
    return {'median': statistics.median(values), 'q1': q[0], 'q3': q[2]}


def _per_call_ns(body, n, repeats=5):
    """The least over ``repeats`` of ``body(n)``'s time over n, ns."""
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        body(n)
        dt = time.perf_counter_ns() - t0
        best = dt if best is None else min(best, dt)
    return best / n


def span_cost_ns(tracing):
    """Host ns a call of a ``span`` entered and left, off and on (no
    profiler), and a shared null context's, each less an empty loop's."""
    null = contextlib.nullcontext()

    def bare(n):
        for _ in range(n):
            pass

    def with_null(n):
        for _ in range(n):
            with null:
                pass

    def with_span(n):
        for _ in range(n):
            with tracing.span('train.step', 0):
                pass

    tracing.disable()
    base = _per_call_ns(bare, 1_000_000)
    out = {'null_context': _per_call_ns(with_null, 1_000_000) - base,
           'off': _per_call_ns(with_span, 1_000_000) - base}
    tracing.enable()
    on = []
    for _ in range(5):
        on.append(_per_call_ns(with_span, 10_000, repeats=1) - base)
        tracing.take()
    tracing.disable()
    out['on'] = min(on)
    return out


def launch_checks(events, reduced, attributed, steps):
    """The launches and idle gaps put down to spans, against the trace's own
    counts; which runtime events launched the loss-head kernels."""
    import torch

    p = spans.parse(events)
    a_starts = [a[0] for a in p.annotations]
    in_step = under = 0
    for t in p.launches:
        if _at(p.annotations, a_starts, t) == 'bench.train_step':
            in_step += 1
            under += p.spans.at(t) is not None
    idle_step = sum(v for k, v in attributed['idle_gaps'] if k.startswith('bench.train_step'))
    idle_named = sum(v for k, v in attributed['idle_gaps']
                     if k.startswith('bench.train_step > train.'))
    runtime, by_correlation = {}, {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA and 'Launch' in e.name():
            runtime[e.name()] = runtime.get(e.name(), 0) + 1
            by_correlation[e.correlation_id()] = e.name()
    loss_head = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and 'dsnt_jsd' in e.name():
            key = f'{e.name()[:40]} <- {by_correlation.get(e.correlation_id())}'
            loss_head[key] = loss_head.get(key, 0) + 1
    total = sum(attributed['span_launches'].values())
    return {
        'launches_per_step': reduced['launches'] / steps,
        'span_launches_per_step': {k: v / steps for k, v in attributed['span_launches'].items()},
        'span_launches_sum_over_launches': (total / reduced['launches']
                                            if reduced['launches'] else None),
        'train_step_launches_under_a_phase': under / in_step if in_step else None,
        'train_step_idle_s': idle_step,
        'train_step_idle_named_share': idle_named / idle_step if idle_step else None,
        'runtime_launch_events': runtime,
        'loss_head_launched_by': loss_head,
        'idle_gaps': attributed['idle_gaps'][:trace.TOP],
        'idle_gaps_unlabelled': reduced['idle_gaps'],
        'window_s': reduced['window_s'], 'busy_s': reduced['busy_s'],
    }


def measure(ctx):
    """The tool's numbers for the train cell's context ``ctx``."""
    import torch

    from margipose_tpu_torch import tracing
    from margipose_tpu_torch.utils import init_algorithms

    train = common.load_module('drivers', 'train')
    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    cuda = device.type == 'cuda'
    out = {'workload': CELL, 'seed': ctx.seed,
           'device': torch.cuda.get_device_name(device) if cuda else 'cpu'}

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pool = traffic.batches(ctx.traffic, cfg['n_joints'], ctx.seed)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    init_algorithms(deterministic=False)
    state, step, feed = train.program(ctx, state_dict, pool)
    del state_dict
    tracing.enable()
    train.judged_steps(state, step, feed, wl['warm_steps'])
    sync()
    out['first_step_s'] = spans.first_step_s(tracing.take())
    tracing.disable()
    out['setup_s'] = common.process_age()
    common.log(f'set-up {out["setup_s"]:.1f} s, first step {out["first_step_s"]:.3f} s')

    i = wl['warm_steps']
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        step(state, feed(i))
        i += 1
    sync()
    window_s = time.perf_counter() - t0
    steps = i - wl['warm_steps']
    out['window'] = {'steps': steps, 'ms_a_step': 1e3 * window_s / steps,
                     'train_images_per_s': steps * ctx.traffic['batch'] / window_s}
    common.log(f'window {out["window"]}')

    tracing.enable()
    t0 = time.perf_counter()
    for _ in range(SPAN_STEPS):
        step(state, feed(i))
        i += 1
    sync()
    wall_ms = 1e3 * (time.perf_counter() - t0) / SPAN_STEPS
    host = spans.host_ms(tracing.take())
    out['span_stretch'] = {'steps': SPAN_STEPS, 'wall_ms_a_step': wall_ms,
                           'host_ms': host, 'step_over_wall': host[spans.STEP] / wall_ms}
    common.log(f'span stretch {out["span_stretch"]}')

    n = wl['trace_steps']
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(n):
                with trace.span('upload', True):
                    batch = feed(i)
                with trace.span('train_step', True):
                    step(state, batch)
                i += 1
            sync()
    tracing.take()
    tracing.disable()
    events = prof.profiler.kineto_results.events()
    reduced = trace.reduce(events)
    out['traced'] = launch_checks(events, reduced, spans.attribute(events), n)
    del prof, events
    common.log(f'traced {json.dumps(out["traced"])}')

    diffs, on_ms, off_ms = [], [], []
    for pair in range(PAIRS):
        ms = {}
        for on in ((True, False) if pair % 2 == 0 else (False, True)):
            (tracing.enable if on else tracing.disable)()
            sync()
            t0, k = time.perf_counter(), 0
            while time.perf_counter() - t0 < SLICE_SECONDS:
                step(state, feed(i))
                i += 1
                k += 1
            sync()
            ms[on] = 1e3 * (time.perf_counter() - t0) / k
            tracing.take()
        tracing.disable()
        diffs.append(ms[True] - ms[False])
        on_ms.append(ms[True])
        off_ms.append(ms[False])
    out['cost_on'] = {'pairs': PAIRS, 'slice_s': SLICE_SECONDS,
                      'on_minus_off_ms': _quartiles(diffs), 'diffs_ms': diffs,
                      'on_ms': _quartiles(on_ms), 'off_ms': _quartiles(off_ms)}
    common.log(f'cost on, slices {out["cost_on"]}')
    # single steps in turn: neighbours share the host's speed, which drifts
    # over seconds; a step's host time, no synchronize (the device waits)
    diffs = []
    for pair in range(STEP_PAIRS):
        ms = {}
        for on in ((True, False) if pair % 2 == 0 else (False, True)):
            (tracing.enable if on else tracing.disable)()
            t0 = time.perf_counter()
            step(state, feed(i))
            ms[on] = 1e3 * (time.perf_counter() - t0)
            i += 1
        diffs.append(ms[True] - ms[False])
    sync()
    tracing.disable()
    tracing.take()
    out['cost_on_steps'] = {'pairs': STEP_PAIRS, 'on_minus_off_ms': _quartiles(diffs)}
    out['span_ns'] = span_cost_ns(tracing)
    out['checks'] = checks(out)
    return out


def _within(value, lo, hi):
    return None if value is None else lo <= value <= hi


def checks(out):
    """The span metrics' acceptance on ``measure``'s numbers, each True,
    False, or None where the run had nothing to read (no launch, no idle
    time): the launches under the spans sum to the trace's within 1%; 99% of
    ``bench.train_step``'s launches and 90% of its idle time fall in a
    phase; the median ``train.step`` is within 5% of the span stretch's wall
    ms a step; a disabled ``span()`` costs under 1 us."""
    traced = out['traced']
    return {
        'launches_add_up': _within(traced['span_launches_sum_over_launches'], 0.99, 1.01),
        'step_launches_in_a_phase': _within(traced['train_step_launches_under_a_phase'],
                                            0.99, 1.0),
        'step_idle_in_a_phase': _within(traced['train_step_idle_named_share'], 0.90, 1.0),
        'step_covers_its_wall': _within(out['span_stretch']['step_over_wall'], 0.95, 1.05),
        'span_off_under_1us': out['span_ns']['off'] < 1000,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    common.set_cache_dirs()
    import torch

    ctx = run.context(common.load_json('workloads', CELL), args.seed,
                      common.spec()['run_seconds'], True, torch.device('cuda'))
    out = measure(ctx)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, 'a') as f:
            f.write(text + '\n')
    return 1 if False in out['checks'].values() else 0


if __name__ == '__main__':
    raise SystemExit(main())
