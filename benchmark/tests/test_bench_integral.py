"""The integral configuration's yardstick and its cell at test size on the
CPU: the configuration's FLOPs and parameters against its reference, the
soft-argmax kernels' byte bounds and their roofline reader, and the
``train_integral`` driver's run (64 px, D = 8, batch 2, float32) correct
when sound and not correct under a planted fault or as the control."""

import copy

import pytest

from benchmark import common, costs, costs_softargmax3d, faults, run
from benchmark.tests.conftest import small_context

CELL = 'integral-r50-train-bf16-b32'
CONFIG = 'integral-resnet50-d64'
SMALL_INTEGRAL = {
    'model_desc': {'type': 'integral', 'version': '1.0.0',
                   'settings': {'depth_dim': 8, 'input_size': 64}},
    'reference': {'module': 'integral', 'class': 'TIntegralPose',
                  'kwargs': {'n_joints': 17, 'depth_dim': 8}},
    'input_size': 64, 'depth_dim': 8, 'heatmap_size': 16,
}


def _context(**workload_entries):
    ctx = small_context(CELL, seconds=0.6, **workload_entries)
    ctx.config.update(copy.deepcopy(SMALL_INTEGRAL))
    ctx.traffic.update(frame=[64, 64])
    return ctx


def test_the_configuration_counts_its_reference():
    config = common.load_json('configs', CONFIG)
    assert costs.forward_flops(config) == config['flops_per_image']
    assert round(config['flops_per_image'] / 1e9, 2) == 16.72
    from benchmark import reference

    import torch

    with torch.device('meta'):
        model = reference.build(config['reference'])
    assert sum(p.numel() for p in model.parameters()) == config['parameters']


@pytest.mark.parametrize('fn, bound_us', [(costs_softargmax3d.fwd_bytes, 85.141),
                                          (costs_softargmax3d.bwd_bytes, 170.281)])
def test_the_kernels_bytes_bounds(fn, bound_us):
    assert round(costs.bound_seconds(fn(544, 64 ** 3, 2)) * 1e6, 3) == bound_us


def test_the_roofline_reader_reads_the_kernels_traced_time():
    obs = {'costs': {'softargmax3d': {'rows': 544, 'volume': 64 ** 3, 'width': 2}},
           'trace': {'kernels': {'void softargmax3d_fwd_kernel<__nv_bfloat16>(x)': [3, 3 * 170e-6],
                                 'void cudnn::conv(x)': [40, 1.0]}}}
    fwd = common.load_module('metrics', 'softargmax3d_fwd_roofline.train').read
    bwd = common.load_module('metrics', 'softargmax3d_bwd_roofline.train').read
    assert fwd(obs) == pytest.approx(100 * 85.141 / 170, rel=1e-4)
    assert bwd(obs) is None  # no backward launch in the trace
    assert fwd({'costs': {}}) is None


def test_a_sound_run_is_correct():
    result = run.run_cell(_context(precision='float32'))
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'setup_s', 'train_images_per_s'}


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch'])
def test_a_planted_fault_is_not_correct(fault):
    ctx = _context(precision='float32')
    with faults.planted(fault):
        result = run.run_cell(ctx)
    assert not result['correct'], result['checks']


def test_the_control_is_not_correct():
    ctx = _context()
    driver = common.load_module('drivers', ctx.workload['driver'])
    readings = driver.control(ctx, ctx.workload['control'])
    limits = ctx.workload['limits']
    correct, checks = common.judge({k: readings[k] for k in limits}, limits)
    assert not correct, checks


def test_a_program_without_the_model_fails(monkeypatch):
    from margipose_tpu_torch import models

    monkeypatch.setattr(models, 'MODEL_FACTORIES',
                        [f for f in models.MODEL_FACTORIES if f[0] != 'integral'])
    with pytest.raises(ValueError, match='unrecognised model'):
        run.run_cell(_context(precision='float32'))
