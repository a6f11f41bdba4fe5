"""The train step captured in a CUDA graph (``train/steps.make_train_step``)
against the same step run eagerly, on the card: a small MargiPose (2
stages, 64 px, batch 4) from one set of seeded weights, stepped by 1cycle
SGD at float32 and at bf16 autocast. cuDNN is held to its deterministic
algorithms, so both paths run the same kernels.

The eager side runs every step through ``steps.eager``. Losses agree
within 1e-5 relative; the parameters' change by the median leaf's gap of
change norms, at most ``UPDATE_GAP``; the BN statistics within 1e-5
relative. Skipped without a card: a graph has no CPU mode."""

import copy

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.ops import _build, launch_counts, zero_launch_counts
from margipose_tpu_torch.train.schedules import make_optimiser
from margipose_tpu_torch.train import steps
from margipose_tpu_torch.train.steps import TrainState, make_train_step, step_counts

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

DESC = {'type': 'margipose', 'version': '6.0.1',
        'settings': {'n_stages': 2, 'axis_permutation': True, 'feature_extractor': 'inceptionv4',
                     'pixelwise_loss': 'jsd', 'input_size': 64}}
# the median leaf's gap of the parameters' change, graphed against eager:
# the limit the port's train cell holds a bf16 run to against its float32
# reference, so a graphed step that passes here is no further from the eager
# step than the cell allows (with the same deterministic kernels it reads
# about 0)
UPDATE_GAP = 0.07
PRECISIONS = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (a CUDA graph has no CPU mode)')
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    yield torch.device('cuda')
    cudnn.benchmark, cudnn.deterministic = saved


def _batch(seed, device, batch=4, size=64):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(batch, 17)
    mask[0, [3, 9]] = 0
    out = {'input': torch.randn(batch, 3, size, size, generator=g),
           'target': torch.rand(batch, 17, 3, generator=g) * 1.6 - 0.8,
           'joint_mask': mask,
           'valid_depth': torch.tensor([1, 0, 1, 1][:batch])}
    return {k: v.to(device) for k, v in out.items()}


def _states(device, n=2):
    model = create_model(DESC, generator=torch.Generator().manual_seed(7)).to(device)
    out = []
    for _ in range(n):
        m = copy.deepcopy(model)
        out.append(TrainState(m, make_optimiser('1cycle', m.parameters(), 1.0, max_iters=10)))
    return out


def _median_leaf_gap(got, want):
    """The median over the parameters of the gap between two norms of their
    change, each relative to the larger of ``want``'s and the median norm;
    parameters that changed by under a thousandth of the median left out."""
    floor = 1e-3 * float(np.median(list(want.values())))
    kept = [k for k, v in want.items() if v >= floor]
    median = float(np.median([want[k] for k in kept]))
    return float(np.median([abs(got[k] - want[k]) / max(want[k], median) for k in kept]))


def _assert_same_training(got, want, start, got_losses, want_losses):
    """``got`` and ``want`` (train states after the same steps from the
    weights ``start``): losses, change of the parameters, BN statistics."""
    np.testing.assert_allclose(torch.stack(got_losses).cpu().numpy(),
                               torch.stack(want_losses).cpu().numpy(), rtol=1e-5)
    got_p, want_p = dict(got.model.named_parameters()), dict(want.model.named_parameters())
    change = [{k: float((p.detach() - start[k]).norm()) for k, p in ps.items()}
              for ps in (got_p, want_p)]
    assert _median_leaf_gap(*change) <= UPDATE_GAP
    got_b, want_b = dict(got.model.named_buffers()), dict(want.model.named_buffers())
    for k, b in want_b.items():
        np.testing.assert_allclose(got_b[k].double().cpu().numpy(), b.double().cpu().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize('precision', PRECISIONS, ids=['float32', 'bfloat16'])
def test_graphed_steps_equal_eager_steps(card, precision):
    graphed, eager = _states(card)
    start = {k: p.detach().clone() for k, p in graphed.model.named_parameters()}
    step, eager_step = make_train_step('jsd', precision), make_train_step('jsd', precision)
    got, want = [], []
    for seed in range(6):
        got.append(step(graphed, _batch(seed, card))['loss'])
        want.append(steps.eager(eager_step, eager, _batch(seed, card))['loss'])
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 4)
    assert (eager_step.eager_steps, eager_step.captures, eager_step.replays) == (6, 0, 0)
    assert graphed.step == graphed.optimiser.count == 6
    assert len({t.data_ptr() for t in got}) == 6  # copies, not the graph's outputs
    _assert_same_training(graphed, eager, start, got, want)


@pytest.mark.cuda
def test_a_restore_mid_run_then_replays_equal_eager_steps(card):
    """Steps 1-2, a checkpoint, steps 3-4, the checkpoint restored, steps
    3-6 again: the restored buffers are new tensors, so the graph goes,
    step 3 runs eagerly, step 4 captures anew and 5-6 replay; all as six
    eager steps give."""
    graphed, eager = _states(card)
    start = {k: p.detach().clone() for k, p in graphed.model.named_parameters()}
    step, eager_step = make_train_step('jsd'), make_train_step('jsd')
    for seed in range(2):
        step(graphed, _batch(seed, card))
    saved = (copy.deepcopy(graphed.model.state_dict()),
             copy.deepcopy(graphed.optimiser.state_dict()), graphed.step)
    for seed in (2, 3):
        step(graphed, _batch(seed, card))
    first = graphed.graph
    graphed.model.load_state_dict(saved[0])
    graphed.optimiser.load_state_dict(saved[1])
    graphed.step = saved[2]
    got = [step(graphed, _batch(2, card))['loss']]
    assert graphed.graph is None and first is not None
    got += [step(graphed, _batch(seed, card))['loss'] for seed in (3, 4, 5)]
    assert (step.eager_steps, step.captures, step.replays) == (2, 2, 4)
    want = [steps.eager(eager_step, eager, _batch(seed, card))['loss'] for seed in range(6)]
    _assert_same_training(graphed, eager, start, got, want[2:])


@pytest.mark.cuda
def test_a_short_batch_runs_eagerly_and_the_next_full_batch_replays(card):
    graphed, eager = _states(card)
    start = {k: p.detach().clone() for k, p in graphed.model.named_parameters()}
    step, eager_step = make_train_step('jsd'), make_train_step('jsd')
    sizes = [4, 4, 4, 2, 4, 2, 4]
    got = [step(graphed, _batch(i, card, batch=b))['loss'] for i, b in enumerate(sizes[:3])]
    graph = graphed.graph
    got += [step(graphed, _batch(i, card, batch=b))['loss'] for i, b in enumerate(sizes) if i >= 3]
    assert graphed.graph is graph  # the short batches never replaced it
    assert (step.eager_steps, step.captures, step.replays) == (3, 1, 3)
    want = [steps.eager(eager_step, eager, _batch(i, card, batch=b))['loss']
            for i, b in enumerate(sizes)]
    _assert_same_training(graphed, eager, start, got, want)


@pytest.mark.cuda
def test_a_replay_runs_both_loss_head_kernels_with_no_host_launch(card):
    """The wrappers count host launches: one of each on the eager and the
    capturing step, none on a replay. The device trace of the same steps,
    capture included, shows both kernels run once a step."""
    (state,) = _states(card, n=1)
    step = make_train_step('jsd', torch.bfloat16)
    counts = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for seed in range(5):
            zero_launch_counts()
            step(state, _batch(seed, card))
            counts.append(tuple(launch_counts('dsnt_jsd_fwd', 'dsnt_jsd_bwd').values()))
        torch.cuda.synchronize()
    assert counts == [(1, 1), (1, 1), (0, 0), (0, 0), (0, 0)]
    assert step_counts(step) == {'eager_steps': 1, 'captures': 1, 'replays': 3}
    ran = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    assert [sum(f'dsnt_jsd_{way}_kernel' in n for n in ran) for way in ('fwd', 'bwd')] == [5, 5]


INTEGRAL_DESC = {'type': 'integral', 'version': '1.0.0',
                 'settings': {'depth_dim': 8, 'input_size': 64}}
TRANSPOSES = ('nchwToNhwc', 'nhwcToNchw')
ATEN_BATCH_NORM = ('batch_norm_collect_statistics', 'batch_norm_backward',
                   'batch_norm_transform_input')


@pytest.mark.cuda
def test_a_replayed_channels_last_step_equals_an_eager_one_bit_for_bit(card):
    """bf16: the model and its momentum buffers channels-last from the
    first step on; four graphed steps and four eager ones give the same
    losses, parameters, buffers and momentum buffers, bit for bit."""
    graphed, eager = _states(card)
    step, eager_step = make_train_step('jsd', torch.bfloat16), make_train_step('jsd', 'bfloat16')
    got = [step(graphed, _batch(seed, card))['loss'] for seed in range(4)]
    want = [steps.eager(eager_step, eager, _batch(seed, card))['loss'] for seed in range(4)]
    assert step_counts(step) == {'eager_steps': 1, 'captures': 1, 'replays': 2}
    assert torch.equal(torch.stack(got), torch.stack(want))
    for state in (graphed, eager):
        convs = [p for p in state.model.parameters() if p.ndim == 4]
        assert all(p.is_contiguous(memory_format=torch.channels_last) for p in convs)
        opt = state.optimiser.optimiser.state
        assert all(opt[p]['momentum_buffer'].stride() == p.stride() for p in convs)
    sd = [s.model.state_dict() for s in (graphed, eager)]
    assert [k for k in sd[0] if not torch.equal(sd[0][k], sd[1][k])] == []
    bufs = [[s.optimiser.optimiser.state[p]['momentum_buffer'] for p in s.model.parameters()]
            for s in (graphed, eager)]
    assert all(torch.equal(a, b) for a, b in zip(*bufs))
    assert graphed.graph.inputs['input'].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize('desc', [DESC, INTEGRAL_DESC], ids=['flagship', 'integral'])
def test_a_replayed_bf16_step_runs_no_transpose_and_the_channels_last_batch_norms(card, desc):
    """A replayed bf16 step's device trace: no cuDNN layout transpose, no
    ATen train-mode batch norm, and each batch norm's channels-last forward
    and backward once; a float32 step keeps the NCHW kernels."""
    for precision, fwd, bwd in ((torch.bfloat16, 'batch_norm_train_nhwc_fwd',
                                 'batch_norm_train_nhwc_bwd'),
                                (torch.float32, 'batch_norm_train_fwd', 'batch_norm_train_bwd')):
        model = create_model(desc, generator=torch.Generator().manual_seed(7)).to(card)
        layers = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, max_iters=10))
        step = make_train_step('jsd', precision)
        for seed in range(2):
            step(state, _batch(seed, card))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, _batch(2, card))
            torch.cuda.synchronize()
        assert step_counts(step) == {'eager_steps': 1, 'captures': 1, 'replays': 1}
        ran = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        if precision == torch.bfloat16:
            assert not [n for n in ran if any(w in n for w in TRANSPOSES)]
        assert not [n for n in ran if any(w in n for w in ATEN_BATCH_NORM)]
        assert [sum(any(w in n for w in _build.KERNELS[s].traced) for n in ran)
                for s in (fwd, bwd)] == [layers, layers]
