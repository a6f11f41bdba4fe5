"""A run with the timed path broken underneath comes out not correct, and
so does the control: the reference one precision lower in the program's
place. Each cell's whole run at test size on the CPU (the look for a chip
skipped), under the cell's own limits. The sound runs here are float32, so
that only the planted fault can fail them."""

import pytest

from benchmark import common, faults, run
from benchmark.tests.conftest import small_context

FAULTS = {
    'margipose-train-bf16-b32': ['unchanged', 'half_batch'],
    'chatterbox-eval-f32-b32': ['half_batch', 'altered'],
    'margipose-serve-bf16-b8': ['half_batch', 'altered'],
    'margipose-ddp4-train-bf16-b32': ['no_exchange', 'half_batch'],
}
# every cell's file, those BENCHMARK.json does not list yet included
CELLS = common.names('workloads')


def _context(cell):
    # full batches for the serve cell, so that half of one holds answers
    ctx = small_context(cell, seconds=0.6, precision='float32')
    if 'rate' in ctx.traffic:
        ctx.traffic['rate'] = 200.0
    return ctx


@pytest.mark.parametrize('cell', CELLS)
def test_a_sound_run_is_correct(cell):
    result = run.run_cell(_context(cell))
    assert result['correct'], result['checks']


@pytest.mark.parametrize('cell, fault', [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(cell, fault):
    ctx = _context(cell)
    ctx.fault = fault  # a driver's worker processes plant it themselves
    with faults.planted(fault):
        result = run.run_cell(ctx)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('cell', [c for c in CELLS if common.load_json('workloads', c)['chips'] == 1])
def test_the_control_is_not_correct(cell):
    ctx = small_context(cell)
    driver = common.load_module('drivers', ctx.workload['driver'])
    readings = driver.control(ctx, ctx.workload['control'])
    limits = ctx.workload['limits']
    correct, checks = common.judge({k: readings[k] for k in limits}, limits)
    assert not correct, checks
