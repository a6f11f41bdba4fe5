"""The yardstick's arithmetic against the numbers it was set from."""

import pytest

from benchmark import common, costs


@pytest.mark.parametrize('name, gflop', [('margipose-v6.0.1', 53.84), ('chatterbox-v1.3.0', 70.26)])
def test_forward_flops_match_the_configuration(name, gflop):
    config = common.load_json('configs', name)
    flops = costs.forward_flops(config)
    assert flops == config['flops_per_image']
    assert round(flops / 1e9, 2) == gflop


@pytest.mark.parametrize('fn, rows, bound_us', [
    (costs.dsnt_jsd_fwd_bytes, 6528, 8.028), (costs.dsnt_jsd_bwd_bytes, 6528, 16.010),
    (costs.dsnt_jsd_fwd_bytes, 1632, 2.007)])
def test_loss_head_bounds(fn, rows, bound_us):
    assert round(costs.bound_seconds(fn(rows, 32, 32)) * 1e6, 3) == bound_us


@pytest.mark.parametrize('name, batch, rows', [('margipose-v6.0.1', 32, 6528),
                                               ('chatterbox-v1.3.0', 32, 1632)])
def test_loss_head_rows(name, batch, rows):
    assert costs.loss_head_rows(common.load_json('configs', name), batch) == rows
