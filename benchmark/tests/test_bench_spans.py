"""The program's spans in the benchmark (``benchmark/spans.py``) on made-up
records and a made-up trace, and the trace's existing readings unmoved by
the program's spans in it."""

import pytest
import torch

from benchmark import common, spans, trace
from margipose_tpu_torch.tracing import Span

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device=CPU):
        self._name, self._start, self._end, self._device = name, start, end, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device


def _step(step, start, phases):
    """A step's records: its train.step span, then each (name, start, end)."""
    out = [Span('train.step', None, start, None, step)]
    for name, s, e in phases:
        out.append(Span(name, None, s, e, step))
    out[0].end_ns = max(e for _, _, e in phases) + 1_000_000
    return out


def _records():
    ms = 1_000_000
    out = []
    for k, (t, fwd) in enumerate([(0, 80), (200 * ms, 90), (400 * ms, 70)]):
        rows = _step(k, t, [('train.forward', t + ms, t + (1 + fwd) * ms),
                            ('train.loss', t + 100 * ms, t + 103 * ms),
                            ('train.backward', t + 104 * ms, t + 184 * ms),
                            ('train.update', t + 185 * ms, t + 192 * ms)])
        base = len(out)
        for r in rows[1:]:
            r.parent = base
        out += rows
    return out


def test_host_ms_is_each_phases_median_and_the_steps_own_time():
    got = spans.host_ms(_records())
    assert got['train.forward'] == pytest.approx(80.0)
    assert got['train.loss'] == pytest.approx(3.0)
    assert got['train.backward'] == pytest.approx(80.0)
    assert got['train.update'] == pytest.approx(7.0)
    assert got['train.step'] == pytest.approx(193.0)
    # 193 ms less 170, 180 or 160 in the children: median 23
    assert got[spans.SELF] == pytest.approx(23.0)
    assert spans.first_step_s(_records()) == pytest.approx(0.193)


def test_host_ms_and_first_step_read_nothing_without_a_complete_step():
    assert spans.host_ms([]) == {} and spans.first_step_s([]) is None
    lone = [Span('train.step', None, 0, 10, 0), Span('train.forward', 0, 1, 5, 0)]
    assert spans.host_ms(lone) == {}
    assert spans.first_step_s([Span('train.step', None, 0, None, 0)]) is None


def _trace(program_spans=True):
    """A window of 1000 ns: one step whose forward holds a convolution."""
    events = [Event('bench.window', 0, 1000), Event('bench.upload', 10, 90),
              Event('bench.train_step', 100, 900), Event('aten::conv2d', 130, 390),
              Event('aten::convolution_backward', 460, 790),
              Event('cudaGraphLaunch', 50, 55), Event('cudaMemcpyAsync', 60, 70),
              Event('cudaLaunchKernel', 150, 155), Event('cudaLaunchKernelExC', 395, 398),
              Event('cuLaunchKernel', 500, 505),  # on the autograd engine's thread
              Event('cudaLaunchKernel', 850, 852),
              Event('cudaLaunchKernel', 1100, 1105),
              Event('void conv_kernel(x)', 160, 200, CUDA), Event('Memcpy HtoD', 60, 80, CUDA),
              Event('void dsnt_jsd_fwd_kernel(x)', 380, 520, CUDA),
              Event('void dgrad_kernel(x)', 600, 700, CUDA),
              Event('bench.train_step', 100, 900, CUDA)]
    if program_spans:
        named = [('train.step', 110, 890), ('train.forward', 120, 400),
                 ('train.loss', 400, 450), ('train.backward', 450, 800),
                 ('train.update', 800, 880)]
        events += [Event(n, s, e) for n, s, e in named]
        events += [Event(n, s, e, CUDA) for n, s, e in named]  # their device shadows
    return events


def test_a_launch_counts_under_the_innermost_span_and_a_gap_names_it():
    got = spans.attribute(_trace())
    assert got['span_launches'] == {spans.NONE: 1, 'train.forward': 2, 'train.backward': 1,
                                    'train.update': 1}
    assert {k: round(v * 1e9) for k, v in got['idle_gaps']} == {
        'bench.upload': 60, 'bench.train_step > train.forward': 80,
        'bench.train_step > train.forward > aten::conv2d': 180,
        'bench.train_step > train.backward > aten::convolution_backward': 80,
        'bench.train_step > train.update': 300}
    # sorted by seconds
    assert got['idle_gaps'][0][0] == 'bench.train_step > train.update'


def test_without_program_spans_every_launch_is_in_none_and_gaps_keep_their_labels():
    got = spans.attribute(_trace(program_spans=False))
    assert got['span_launches'] == {spans.NONE: 5}
    unlabelled = trace.reduce(_trace(program_spans=False))
    assert sorted(got['idle_gaps']) == sorted(unlabelled['idle_gaps'])


def test_the_innermost_span_over_a_time():
    nested = spans.Nested([(0, 100, 'a'), (10, 40, 'b'), (10, 20, 'c'), (50, 60, 'd'),
                           (200, 300, 'e')])
    assert [nested.at(t) for t in (0, 10, 19, 20, 45, 55, 99, 100, 150, 250, 300)] == [
        'a', 'c', 'c', 'b', 'a', 'd', 'a', None, None, 'e', None]


def test_every_existing_reader_reads_the_same_with_and_without_program_spans():
    costs = {'flops_per_image': 53.84e9, 'passes_per_image': 3, 'peak_flops': 989e12,
             'loss_head_rows': 6528, 'heatmap': 32}
    reduced = [trace.reduce(_trace(p)) for p in (False, True)]
    assert reduced[0] == reduced[1]
    obs = [{'trace': dict(r, steps=1), 'costs': costs, 'images': 32, 'window_s': 0.2}
           for r in reduced]
    for m in common.spec()['per_layer']:
        read = common.load_module('metrics', m['name']).read
        assert read(obs[0]) == read(obs[1]), m['name']


def _numbers(launch_sum=1.0, under=1.0, idle_named=0.95, step_over_wall=0.97, off_ns=300.0):
    return {'traced': {'span_launches_sum_over_launches': launch_sum,
                       'train_step_launches_under_a_phase': under,
                       'train_step_idle_named_share': idle_named},
            'span_stretch': {'step_over_wall': step_over_wall}, 'span_ns': {'off': off_ns}}


@pytest.mark.parametrize('numbers, failed', [
    (_numbers(), None),
    (_numbers(launch_sum=0.99, under=0.99, idle_named=0.9, step_over_wall=1.05), None),
    (_numbers(launch_sum=1.011), 'launches_add_up'),
    (_numbers(launch_sum=0.98), 'launches_add_up'),
    (_numbers(under=0.985), 'step_launches_in_a_phase'),
    (_numbers(idle_named=0.89), 'step_idle_in_a_phase'),
    (_numbers(step_over_wall=0.94), 'step_covers_its_wall'),
    (_numbers(step_over_wall=1.06), 'step_covers_its_wall'),
    (_numbers(off_ns=1000.0), 'span_off_under_1us'),
])
def test_the_tools_checks_hold_their_limits(numbers, failed):
    from benchmark.tools import train_spans

    got = train_spans.checks(numbers)
    assert [k for k, v in got.items() if v is False] == ([failed] if failed else [])
    assert None not in got.values()


def test_the_tool_measures_the_train_cell_at_test_size(monkeypatch):
    """``measure`` end to end on the CPU, its stretches cut short: the
    checks a run without a device can read hold, and the launch checks read
    nothing there. (Without a device the traced window is one idle gap, so
    its idle check reads where the gap's middle fell, and is not asserted.)"""
    from benchmark.tests.conftest import small_context
    from benchmark.tools import train_spans

    for name, value in (('SPAN_STEPS', 3), ('PAIRS', 2), ('SLICE_SECONDS', 0.1),
                        ('STEP_PAIRS', 2)):
        monkeypatch.setattr(train_spans, name, value)
    out = train_spans.measure(small_context(train_spans.CELL, seconds=0.2,
                                            precision='float32'))
    assert out['first_step_s'] > 0 and out['window']['steps'] > 0
    assert set(out['span_stretch']['host_ms']) == set(spans.SPANS) | {spans.SELF}
    got = dict(out['checks'])
    del got['step_idle_in_a_phase']
    assert got == {'launches_add_up': None, 'step_launches_in_a_phase': None,
                   'step_covers_its_wall': True, 'span_off_under_1us': True}
