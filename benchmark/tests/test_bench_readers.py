"""The readers and the serve sweep's backlog rule on made-up observations."""

import numpy as np
import pytest

from benchmark import common
from benchmark.tools import sweep_serve


def _traced(kernels, steps=3):
    return {'trace': {'kernels': kernels, 'steps': steps, 'busy_s': 0.2, 'window_s': 1.0,
                      'launches': sum(v[0] for v in kernels.values())}}


def test_nccl_ms_per_step_reads_the_nccl_kernels_a_step():
    obs = _traced({'ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)': [12, 0.3],
                   'ncclDevKernel_Broadcast_RING_LL(x)': [3, 0.084],
                   'void cudnn::conv(x)': [40, 1.0]})
    read = common.load_module('metrics', 'nccl_ms_per_step.ddp').read
    assert read(obs) == pytest.approx(128.0)


@pytest.mark.parametrize('kernels, steps', [({'void cudnn::conv(x)': [40, 1.0]}, 3),
                                            ({'ncclDevKernel_AllReduce(x)': [4, 0.1]}, 0)])
def test_nccl_ms_per_step_reads_nothing_without_nccl_kernels_or_steps(kernels, steps):
    read = common.load_module('metrics', 'nccl_ms_per_step.ddp').read
    assert read(_traced(kernels, steps)) is None


def test_the_backlog_counts_requests_due_and_not_answered():
    due = np.array([0.0, 1.0, 2.0, 3.0])
    latency = np.array([2.5, 0.5, np.inf, 0.2])
    assert sweep_serve.backlog(due, latency).tolist() == [1, 2, 2, 2]


def test_a_service_past_its_capacity_grows_its_backlog_and_one_below_does_not():
    due = np.arange(1000) / 100.0  # 100 requests a second for 10 s
    below = np.full(1000, 0.05)  # each answered 50 ms after it was due
    past = np.arange(1000) / 80.0 - due + 0.05  # answered at 80 a second
    assert abs(sweep_serve.growth(due, below)) < 1
    assert sweep_serve.growth(due, past) > 100
