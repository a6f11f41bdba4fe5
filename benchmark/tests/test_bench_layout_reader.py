"""The ``layout_transpose_ms.train`` reader on made-up traces: cuDNN's
layout transposes around NHWC convolutions of an NCHW model, none in a
channels-last step, and no trace."""

import pytest

from benchmark import common

NCHW = {'void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(x)': [3000, 0.0260],
        'void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>(x)': [1500, 0.0114],
        'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc(x)': [900, 0.02],
        'void (anonymous namespace)::batch_norm_train_fwd_kernel<__nv_bfloat16, 8>(x)':
        [1137, 0.006]}
CHANNELS_LAST = {
    'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc(x)': [900, 0.02],
    'void (anonymous namespace)::batch_norm_train_nhwc_fwd_kernel<__nv_bfloat16, 8>(x)':
    [1137, 0.006]}


def _traced(kernels, steps=3):
    return {'trace': {'kernels': kernels, 'steps': steps, 'busy_s': 0.2, 'window_s': 1.0,
                      'launches': sum(v[0] for v in kernels.values())}}


def _read(obs):
    return common.load_module('metrics', 'layout_transpose_ms.train').read(obs)


@pytest.mark.parametrize('kernels, ms', [(NCHW, 12.466666), (CHANNELS_LAST, 0.0)],
                         ids=['nchw', 'channels-last'])
def test_layout_transpose_ms_reads_cudnns_transposes_a_step(kernels, ms):
    assert _read(_traced(kernels)) == pytest.approx(ms)


@pytest.mark.parametrize('obs', [_traced(NCHW, steps=0), {'steps': 3}],
                         ids=['no steps', 'no trace'])
def test_layout_transpose_ms_reads_nothing_without_steps_or_a_trace(obs):
    assert _read(obs) is None
