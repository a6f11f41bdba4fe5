"""Single-image requests to the pose service on one card: what its callers
wait.

Set-up makes the seeded weights and loads them into the port's model, sets
the server's cuDNN policy (heuristics: ``create_server`` turns the timed
search off) and wraps ``bin/serve.model_runner`` (upload as uint8, forward
at ``precision``, read-back) in ``bin/serve.Microbatcher`` at the server's
defaults (``batch_size``, ``max_wait_ms``), as ``create_server`` does, with
a span of the benchmark's own around each runner call and the batcher's
``on_batch`` counting each batch's requests. It warms the one batch shape on
the batcher's thread, as ``create_server`` does.

The window offers an open loop: request i is due ``traffic.arrivals`` after
the window's start and asks for one decoded uint8 frame of a seeded pool;
the generator submits it when due, and a caller thread waits for each result
in turn. A request's latency runs from when it was due to when its caller
had the result, so a stall counts against every request behind it.
``serve_p95_ms`` is the 95th percentile (nearest rank) over every request
due in the window, a failed or unanswered one counting as missing every
limit; the callers wait up to ``patience_s`` past the window for the last.

After the window, with the program's model freed, the plain reference
(float32, TF32 off) runs every pool frame, and every answered request is
judged against its frame's by its widest coordinate gap. The number compared
is the mean of those gaps over the same mean of a witness: the reference
again with its convolutions' operands and outputs rounded to bfloat16
(``reference/lowp``), so the bf16 policy's own error on these weights. How
far a seeded model's answers move under rounding varies 4-6x from seed to
seed, as much in bf16 as in fp8, which sets a bare gap's readings of sound
runs and of the control too close for a limit between them; the ratio holds
each seed to its own (``PERF.md`` gives the readings).
"""

import math
import queue
import threading
import time

import numpy as np
import torch

from benchmark import common, compare, trace, traffic, weights
from benchmark.drivers.train import reference_model
from benchmark.reference import inputs
from benchmark.reference.margipose import t_spread

FRAMES = 3  # the traffic's stream of pool frames


@torch.no_grad()
def reference_outputs(model, frames, device, block=32):
    """(coordinates, their spread) of every frame from ``model``, ``block``
    frames at a time: [N, J, 3] each."""
    xyz, spread = [], []
    for s in range(0, len(frames), block):
        x = inputs.normalise(torch.from_numpy(frames[s:s + block]).to(device))
        coords, hms = model.eval()(x)
        xyz.append(coords.cpu().numpy())
        spread.append(t_spread(*(h[-1] for h in hms)).cpu().numpy())
    return np.concatenate(xyz), np.concatenate(spread)


def setup(ctx):
    """The service as the cell configures it: (batcher, its counters, the
    frames, the seeded state dict)."""
    from margipose_tpu_torch.bin.serve import Microbatcher, model_runner
    from margipose_tpu_torch.models import data_specs_for_desc

    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    size = cfg['input_size']
    frames = traffic.frames((ctx.traffic['pool'], size, size, 3), ctx.seed, FRAMES)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    model = common.port_model(cfg, state_dict, device)
    runner = model_runner(model, data_specs_for_desc(cfg['model_desc']).input_specs,
                          wl['precision'], device)
    counters = {'runner_s': [], 'occupancy': [], 'traced': False}

    def timed_runner(batch):
        with trace.span('runner', counters['traced']):
            t0 = time.perf_counter()
            out = runner(batch)
            counters['runner_s'].append(time.perf_counter() - t0)
        return out

    batcher = Microbatcher(timed_runner, wl['batch_size'], wl['max_wait_ms'] / 1000.0)
    # through the batcher, on its thread, as create_server warms: cuDNN keeps
    # its plans per thread; then a full batch
    for n in (1, wl['batch_size']):
        items = [batcher.submit(frames[i]) for i in range(n)]
        for it in items:
            it.event.wait()
            if it.error is not None:
                raise RuntimeError('serve: the warm-up forward failed') from it.error
    batcher.on_batch = counters['occupancy'].append
    counters['runner_s'].clear()
    return {'batcher': batcher, 'counters': counters, 'frames': frames, 'model': model,
            'state_dict': state_dict}


def offer(service, rate, seconds, seed, patience_s):
    """Offer ``rate`` requests a second for ``seconds``; per request its
    frame, latency (inf if it failed or never came) and result."""
    batcher, frames = service['batcher'], service['frames']
    due, which = traffic.arrivals(rate, seconds, len(frames), seed)
    n = len(due)
    done = np.full(n, np.inf)
    results = [None] * n
    handed = queue.Queue()

    def caller():
        while True:
            entry = handed.get()
            if entry is None:
                return
            i, item, deadline = entry
            if item.event.wait(max(deadline - time.perf_counter(), 0.0)) and item.error is None:
                done[i] = time.perf_counter()
                results[i] = item.result

    thread = threading.Thread(target=caller, daemon=True)
    thread.start()
    late = []
    t0 = time.perf_counter()
    deadline = t0 + seconds + patience_s
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - t0 - due[i])
        handed.put((i, batcher.submit(frames[which[i]]), deadline))
    handed.put(None)
    thread.join()
    latency = done - (t0 + due)
    return {'frames': which, 'latency_s': latency, 'results': results,
            'generator_late_s': float(np.max(late)), 'due': due}


def p95(latency):
    ordered = np.sort(latency)
    return float(ordered[math.ceil(0.95 * len(ordered)) - 1])


def run(ctx):
    wl, device = ctx.workload, ctx.device
    marks = [('imports', common.process_age())]
    service = setup(ctx)
    counters = service['counters']
    setup_s = common.process_age()
    common.log_marks(marks + [('weights and warm batches', setup_s)])
    got = offer(service, ctx.traffic['rate'], ctx.seconds, ctx.seed, wl['patience_s'])
    window = {k: list(v) for k, v in counters.items() if k != 'traced'}
    lat = got['latency_s']
    failed = int((~np.isfinite(lat)).sum())
    obs = {'setup_s': setup_s, 'attempted': len(lat), 'failed': failed,
           'e2e': {wl['metric']: p95(lat) * 1e3},
           'occupancy': window['occupancy'], 'runner_s': window['runner_s']}
    common.log(f'window: {len(lat)} requests at {ctx.traffic["rate"]}/s, {failed} failed, '
               f'p50 {np.median(lat) * 1e3:.3f} ms, p95 {p95(lat) * 1e3:.3f} ms, '
               f'{len(window["occupancy"])} batches, generator at most '
               f'{got["generator_late_s"] * 1e3:.3f} ms late')
    if ctx.trace:
        counters['traced'] = True
        with trace.profiled(device) as tr:
            offer(service, ctx.traffic['rate'], wl['trace_seconds'], ctx.seed + 1,
                  wl['patience_s'])
        counters['traced'] = False
        obs['trace'] = tr
        common.log(f'trace: window {tr["window_s"]:.3f} s, busy {tr["busy_s"]:.3f} s, '
                   f'reduced in {tr["reduce_s"]:.1f} s')
    obs['memory_peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                if device.type == 'cuda' else 0)
    service['batcher'].runner = None  # the idle thread holds the model no more
    del service['model']
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    ref = reference_outputs(reference_model(ctx.config, service['state_dict'], device),
                            service['frames'], device)
    answered = [i for i, r in enumerate(got['results']) if r is not None]
    witness = reference_outputs(reference_model(ctx.config, service['state_dict'], device,
                                                'bf16'), service['frames'], device)
    which = got['frames'][answered]
    obs['readings'], obs['notes'] = readings(
        np.stack([got['results'][i] for i in answered]) if answered else None,
        ref[0][which], ref[1][which], witness[0][which])
    return obs


def readings(answers, ref, spread, witness):
    """(compared, logged): each answer's widest coordinate gap to the
    reference's for its frame, their mean over that of the witness (the
    reference with its convolutions rounded as the bf16 policy rounds
    them), and, logged, the gaps' other statistics."""
    if answers is None:
        return {'coord_gap_ratio': math.inf}, {}
    gaps = compare.answer_gaps(answers, ref)
    bf16 = compare.answer_gaps(witness, ref).mean()
    diff = np.abs(np.asarray(answers, np.float64) - ref)
    z = (diff / spread).reshape(len(diff), -1).max(-1)
    return ({'coord_gap_ratio': float(gaps.mean() / bf16)},
            {'coord_gap_mean': float(gaps.mean()), 'witness_gap_mean': float(bf16),
             'coord_gap_widest': float(gaps.max()), 'z_gap_mean': float(z.mean())})


def control(ctx, fmt):
    """The readings of the reference rounded to ``fmt`` in the program's place."""
    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    size = cfg['input_size']
    frames = traffic.frames((ctx.traffic['pool'], size, size, 3), ctx.seed, FRAMES)
    state_dict = weights.seeded_state_dict(cfg, ctx.seed, device)
    low = reference_outputs(reference_model(cfg, state_dict, device, fmt), frames, device)
    ref = reference_outputs(reference_model(cfg, state_dict, device), frames, device)
    witness = reference_outputs(reference_model(cfg, state_dict, device, 'bf16'), frames, device)
    compared, logged = readings(low[0], *ref, witness[0])
    return dict(compared, **logged)
