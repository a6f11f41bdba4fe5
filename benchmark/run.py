"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

The cell's file (``workloads/NAME.json``) names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``). The
driver sets up, warms every shape the cell uses, measures for ``--seconds``
(nothing compiles inside), with ``--trace 1`` profiles a further stretch of
the same traffic, and last has the plain reference judge what the timed path
produced. With ``--trace 0`` the line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, each read by its reader
(``metrics/<name>.py``), which returns None where it finds nothing to read.
The numbers judged for ``correct`` go last, each beside its limit (the
cell's ``limits``), on standard error and in the line under ``checks``.

Without a CUDA device, with fewer than the cell asks for, or with the JAX
package or JAX in ``sys.modules`` once the window has closed, it prints no
result and exits non-zero.
"""

import argparse
import json
import sys
import types

from benchmark import common


def context(workload, seed, seconds, trace, device):
    """What a driver reads: the cell, its configuration and traffic, the run's
    arguments."""
    return types.SimpleNamespace(workload=workload,
                                 config=common.load_json('configs', workload['config']),
                                 traffic=common.load_json('traffic', workload['traffic']),
                                 seed=seed, seconds=seconds, trace=trace, device=device)


def apply_overrides(ctx, overrides):
    """Replace entries of the cell's ``config``, ``traffic`` and ``workload``
    (the tests' small sizes); kept on ``ctx`` for a driver's workers."""
    for part, entries in overrides.items():
        getattr(ctx, part).update(entries)
    ctx.overrides = overrides


def run_cell(ctx):
    """Drive the cell's driver; the result line's fields."""
    import torch

    ctx.device = torch.device(ctx.device)
    driver = common.load_module('drivers', ctx.workload['driver'])
    obs = driver.run(ctx)
    for name, value in obs.get('notes', {}).items():
        common.log(f'not compared: {name} {value}')
    correct, checks = common.judge(obs['readings'], ctx.workload.get('limits', {}))
    correct = correct and obs['failed'] == 0
    name = ctx.workload['name']
    metrics = {}
    if ctx.trace:
        for m in common.cell_metrics(name, 'per_layer'):
            value = common.load_module('metrics', m['name']).read(obs)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in common.cell_metrics(name, 'end_to_end'):
            value = obs['setup_s'] if m['name'] == 'setup_s' else obs['e2e'][m['name']]
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': correct, 'attempted': obs['attempted'], 'failed': obs['failed'],
              'metrics': metrics}
    if ctx.device.type == 'cuda':
        result['device'] = common.device_record(ctx.workload['chips'],
                                                obs['memory_peak_bytes'])
    else:
        result['device'] = {'platform': 'cpu', 'count': 1}
    if ctx.trace:
        t = obs['trace']
        result['device'].update(busy_s=t['busy_s'], window_s=t['window_s'])
        result['breakdown'] = {'device_ops': t['device_ops'], 'idle_gaps': t['idle_gaps']}
    result['checks'] = checks
    result['notes'] = obs.get('notes', {})
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    common.set_cache_dirs()
    workload = common.load_json('workloads', args.workload)
    # torch's own thread settings, as the bins leave them
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload['chips']:
        common.log(f'benchmark: {args.workload} needs {workload["chips"]} CUDA device(s); '
                   f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
                   f'device_count() {torch.cuda.device_count()}: no result')
        return 2
    ctx = context(workload, args.seed, args.seconds, bool(args.trace), 'cuda')
    result = run_cell(ctx)
    found = common.forbidden_modules()
    if found:
        common.log(f'benchmark: the process holds {found} after the window: no result')
        return 3
    result.pop('notes')
    for name, check in result['checks'].items():
        common.log(f'check {name}: {check["value"]} (limit {check["limit"]})')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
