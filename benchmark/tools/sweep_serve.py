"""Find the serve cell's knee on the chip: the highest offered rate at which
the backlog does not grow over the window.

    python -m benchmark.tools.sweep_serve --workload margipose-serve-bf16-b8 \
        --rates 80,90,100 [--seconds 30] [--seeds 1,2] [--out FILE]

For each seed one service is set up as the cell sets it up, then each rate
is offered in turn for ``--seconds`` (the cell's open loop,
``drivers/serve.offer``), the rates in rising order. The backlog at a
request's due time is the requests due by then less those answered by then.
A rate's backlog grows where its mean over the window's last fifth of
requests is more than one batch over its mean over the second fifth (the
first is the queue filling from empty), or where a request fails or never
comes. A seed's knee is the last rate before the first whose backlog grows;
the knee is the lowest of the seeds'. One JSON line per seed and rate, and
a last one with each seed's knee, the knee and 0.8 of it.
"""

import argparse
import json

import numpy as np

from benchmark import common, run
from benchmark.drivers import serve


def backlog(due, latency):
    """Requests due and not yet answered at each request's due time."""
    answered = np.sort(due + latency)
    return np.arange(1, len(due) + 1) - np.searchsorted(answered, due, side='right')


def growth(due, latency):
    """The backlog's mean over the last fifth of requests less its mean over
    the second fifth."""
    b = backlog(due, latency)
    fifth = max(len(b) // 5, 1)
    return float(b[-fifth:].mean() - b[fifth:2 * fifth].mean())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', default='margipose-serve-bf16-b8')
    parser.add_argument('--rates', required=True)
    parser.add_argument('--seconds', type=float, default=30.0)
    parser.add_argument('--seeds', default='1')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    common.set_cache_dirs()
    import torch

    workload = common.load_json('workloads', args.workload)
    lines, knees = [], {}
    for seed in [int(s) for s in args.seeds.split(',')]:
        ctx = run.context(workload, seed, args.seconds, False, args.device)
        ctx.device = torch.device(ctx.device)
        service = serve.setup(ctx)
        counters = service['counters']
        knee, stalled = None, False
        for rate in [float(r) for r in args.rates.split(',')]:
            counters['runner_s'].clear()
            counters['occupancy'].clear()
            got = serve.offer(service, rate, args.seconds, seed, workload['patience_s'])
            lat = got['latency_s']
            failed = int((~np.isfinite(lat)).sum())
            grew = growth(got['due'], lat)
            grows = failed > 0 or grew > workload['batch_size']
            line = {'seed': seed, 'rate': rate, 'requests': len(lat), 'failed': failed,
                    'backlog_growth': grew, 'backlog_last': int(backlog(got['due'], lat)[-1]),
                    'backlog_grows': grows, 'p50_ms': float(np.median(lat)) * 1e3,
                    'p95_ms': serve.p95(lat) * 1e3,
                    'occupancy': float(np.mean(counters['occupancy'])),
                    'runner_ms': float(np.mean(counters['runner_s'])) * 1e3,
                    'generator_late_ms': got['generator_late_s'] * 1e3}
            lines.append(line)
            print(json.dumps(line), flush=True)
            stalled = stalled or grows
            if not stalled:
                knee = rate
        knees[seed] = knee
        service['batcher'].runner = None
        del service
    found = [k for k in knees.values() if k is not None]
    low = min(found) if len(found) == len(knees) else None
    summary = {'knees': knees, 'knee': low, 'rate': None if low is None else 0.8 * low,
               'device': torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, 'a') as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + '\n')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
