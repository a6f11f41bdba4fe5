"""The train step's spans (``margipose_tpu_torch.tracing``) on the CPU: off
they record nothing and cost a shared null context; on they nest, carry the
step, appear in torch.profiler's trace inside the step, and leave the step's
arithmetic as it was."""

import numpy as np
import pytest
import torch

from margipose_tpu_torch import tracing
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.train.schedules import make_optimiser
from margipose_tpu_torch.train.steps import TrainState, make_train_step

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

PHASES = ['train.forward', 'train.loss', 'train.backward', 'train.update']
DESC = {'type': 'margipose', 'version': '6.0.1',
        'settings': {'n_stages': 2, 'axis_permutation': True, 'feature_extractor': 'inceptionv4',
                     'pixelwise_loss': 'jsd', 'input_size': 64}}


@pytest.fixture(autouse=True)
def _tracing_off_and_empty():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing._open.clear()
    tracing.take()


def _state(seed=3):
    model = create_model(DESC, generator=torch.Generator().manual_seed(seed))
    return TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, max_iters=10))


def _batch(seed=11, batch=2, size=64):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(batch, 17)
    mask[0, 3] = 0
    return {'input': torch.randn(batch, 3, size, size, generator=g),
            'target': torch.rand(batch, 17, 3, generator=g) * 1.6 - 0.8,
            'joint_mask': mask,
            'valid_depth': torch.tensor([1, 0])}


def _host_names(prof):
    return [e for e in prof.events() if e.name in tracing.SPANS]


def test_off_a_span_is_one_shared_null_context_and_records_nothing():
    first = tracing.span('train.step', 0)
    assert tracing.span('train.forward') is first
    assert tracing.span('not.a.span') is first  # off, names are not even looked at
    with first:
        with tracing.span('train.loss'):
            pass
    assert tracing.take() == []


def test_off_the_train_step_puts_no_span_in_the_profilers_trace():
    state, step = _state(), make_train_step('jsd')
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, _batch())
    assert any(e.name.startswith('aten::') for e in prof.events())
    assert _host_names(prof) == []
    assert tracing.take() == []


def test_on_spans_nest_with_their_parent_and_step_and_take_clears_them():
    tracing.enable()
    for step in (7, 8):
        with tracing.span('train.step', step):
            with tracing.span('train.forward'):
                pass
            with tracing.span('train.backward'):
                with tracing.span('train.update', 99):
                    pass
    spans = tracing.take()
    assert [(s.name, s.parent, s.step) for s in spans] == [
        ('train.step', None, 7), ('train.forward', 0, 7), ('train.backward', 0, 7),
        ('train.update', 2, 99),
        ('train.step', None, 8), ('train.forward', 4, 8), ('train.backward', 4, 8),
        ('train.update', 6, 99)]
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert tracing.take() == []


def test_on_a_name_outside_the_list_and_a_take_inside_a_span_raise():
    tracing.enable()
    with pytest.raises(ValueError, match='not one of the recorded spans'):
        tracing.span('train.other')
    with tracing.span('train.step', 0):
        with pytest.raises(RuntimeError, match='between steps'):
            tracing.take()
    assert [s.name for s in tracing.take()] == ['train.step']


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, 'LIMIT', 3)
    tracing.enable()
    for step in range(3):
        with tracing.span('train.step', step):
            with tracing.span('train.forward'):
                pass
    # the third span is the second step's train.step; its child finds no room
    assert [(s.name, s.step) for s in tracing.take()] == [
        ('train.step', 0), ('train.forward', 0), ('train.step', 1)]
    with tracing.span('train.step', 3):
        pass
    assert [s.step for s in tracing.take()] == [3]


def test_a_train_step_records_its_four_phases_in_order():
    state, step = _state(), make_train_step('jsd')
    tracing.enable()
    for _ in range(2):
        step(state, _batch())
    spans = tracing.take()
    assert [s.name for s in spans] == (['train.step'] + PHASES) * 2
    for root in (0, 5):
        step_span = spans[root]
        assert step_span.parent is None and step_span.step == root // 5
        children = [s for s in spans if s.parent == root]
        assert [s.name for s in children] == PHASES
        assert all(s.step == step_span.step for s in children)
        assert all(a.end_ns <= b.start_ns for a, b in zip(children, children[1:]))
        own = (step_span.end_ns - step_span.start_ns) - sum(s.end_ns - s.start_ns
                                                            for s in children)
        assert own >= 0
    assert state.step == 2


def test_under_the_profiler_the_spans_are_host_events_inside_the_step():
    state, step = _state(), make_train_step('jsd')
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, _batch())
    assert [s.name for s in tracing.take()] == ['train.step'] + PHASES
    events = {e.name: e for e in _host_names(prof)}
    assert sorted(events) == sorted(['train.step'] + PHASES)
    outer = events['train.step'].time_range
    ranges = [events[name].time_range for name in PHASES]
    for r in ranges:
        assert outer.start <= r.start and r.end <= outer.end
    assert all(a.end <= b.start for a, b in zip(ranges, ranges[1:]))
    # the forward's operators sit inside the forward's range, on the same clock
    convs = [e.time_range for e in prof.events() if e.name == 'aten::conv2d']
    forward = events['train.forward'].time_range
    assert convs and all(forward.start <= c.start and c.end <= forward.end for c in convs)


def test_the_step_is_bit_equal_with_tracing_on_and_off():
    results = []
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        state, step = _state(seed=5), make_train_step('jsd')
        out = [step(state, _batch(seed=s)) for s in (11, 12)]
        results.append((out, {k: v.clone() for k, v in state.model.state_dict().items()}))
    (off, off_state), (on, on_state) = results
    assert len(tracing.take()) == 10
    for a, b in zip(off, on):
        assert torch.equal(a['loss'], b['loss']) and torch.equal(a['pred'], b['pred'])
    assert off_state.keys() == on_state.keys()
    assert all(torch.equal(off_state[k], on_state[k]) for k in off_state)
    assert np.isfinite(float(off[-1]['loss']))
