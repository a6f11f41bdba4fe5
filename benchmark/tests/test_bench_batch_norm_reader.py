"""The ``batch_norm_ms.train`` reader on made-up traces: ATen's train-mode
batch-norm kernels (the parent's path), the port's, and none."""

import pytest

from benchmark import common

ATEN = {'void at::native::batch_norm_collect_statistics_kernel<float>(x)': [1137, 0.0201],
        'void at::native::batch_norm_transform_input_kernel<c10::BFloat16>(x)': [1137, 0.0081],
        'void at::native::batch_norm_backward_kernel<c10::BFloat16, float>(x)': [1137, 0.0468],
        'void at::native::vectorized_elementwise_kernel<4>(x)': [4548, 0.01],
        'void cudnn::conv(x)': [40, 1.0]}
PORT = {'void (anonymous namespace)::batch_norm_train_fwd_kernel<__nv_bfloat16, 8>(x)':
        [1128, 0.006],
        'void batch_norm_train_fwd_partial_kernel<float, 4>(x)': [9, 3e-4],
        'void batch_norm_train_fwd_apply_kernel<float, 4>(x)': [9, 3e-4],
        'void (anonymous namespace)::batch_norm_train_bwd_kernel<__nv_bfloat16, 8>(x)':
        [1137, 0.0114],
        'void cudnn::conv(x)': [40, 1.0]}


def _traced(kernels, steps=3):
    return {'trace': {'kernels': kernels, 'steps': steps, 'busy_s': 0.2, 'window_s': 1.0,
                      'launches': sum(v[0] for v in kernels.values())}}


def _read(obs):
    return common.load_module('metrics', 'batch_norm_ms.train').read(obs)


@pytest.mark.parametrize('kernels, ms', [(ATEN, 25.0), (PORT, 6.0)], ids=['aten', 'port'])
def test_batch_norm_ms_reads_atens_and_the_ports_kernels_a_step(kernels, ms):
    assert _read(_traced(kernels)) == pytest.approx(ms)


@pytest.mark.parametrize('obs', [
    _traced({'void cudnn::bn_fw_inf_1C11_kernel(x)': [40, 1.0], 'void cudnn::conv(x)': [40, 1.0]}),
    _traced({'batch_norm_train_bwd_kernel(x)': [4, 0.1]}, steps=0),
    {'steps': 3},
], ids=['no batch-norm kernel', 'no steps', 'no trace'])
def test_batch_norm_ms_reads_nothing_without_batch_norm_kernels_steps_or_a_trace(obs):
    assert _read(obs) is None
