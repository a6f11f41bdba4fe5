"""The readings that limits are set from, on the chip, in one process:
the program's on many seeds and the control's on a few.

    python -m benchmark.tools.readings --workload NAME --seeds 1,2,... \
        [--control-seeds 3,4,5] [--seconds 2] [--fault NAME] [--out FILE]

For each program seed it runs the cell as a run does (with a short window)
and prints its readings; for each control seed, the readings of the
reference rounded to the cell's ``control`` format in the program's place
(``drivers/<driver>.control``). With ``--fault`` the program seeds run
with that fault planted (``benchmark/faults.py``). One JSON line each, on
standard output and appended to ``--out``.
"""

import argparse
import contextlib
import json
import time

from benchmark import common, faults, run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--seconds', type=float, default=2.0)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--fault')
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    common.set_cache_dirs()
    workload = common.load_json('workloads', args.workload)
    driver = common.load_module('drivers', workload['driver'])

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(text + '\n')

    for seed in [int(s) for s in args.seeds.split(',') if s]:
        t0 = time.perf_counter()
        ctx = run.context(workload, seed, args.seconds, False, args.device)
        ctx.fault = args.fault  # a driver's worker processes plant it themselves
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            result = run.run_cell(ctx)
        emit({'workload': args.workload, 'side': args.fault or 'program', 'seed': seed,
              'readings': {k: v['value'] for k, v in result['checks'].items()},
              'notes': result['notes'],
              'metrics': result['metrics'], 'seconds': time.perf_counter() - t0})
    for seed in [int(s) for s in args.control_seeds.split(',') if s]:
        import torch

        t0 = time.perf_counter()
        ctx = run.context(workload, seed, args.seconds, False, args.device)
        ctx.device = torch.device(ctx.device)
        fmt = workload['control']
        emit({'workload': args.workload, 'side': f'control_{fmt}', 'format': fmt,
              'seed': seed, 'readings': driver.control(ctx, fmt),
              'seconds': time.perf_counter() - t0})
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
