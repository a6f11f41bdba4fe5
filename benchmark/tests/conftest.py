"""Small sizes for the benchmark's CPU tests: the flagship cut to 2 stages at
64 px, Chatterbox (256 px only) at batches of 2, short windows."""

import copy

import pytest
import torch

from benchmark import common, run

SMALL_MARGIPOSE = {
    'model_desc': {'type': 'margipose', 'version': '6.0.1',
                   'settings': {'n_stages': 2, 'axis_permutation': True, 'input_size': 64,
                                'feature_extractor': 'inceptionv4', 'pixelwise_loss': 'jsd'}},
    'reference': {'module': 'margipose', 'class': 'TMargiPose',
                  'kwargs': {'n_joints': 17, 'n_stages': 2, 'axis_permutation': True}},
    'input_size': 64, 'heatmap_size': 8, 'loss_head_groups': 6,
}


@pytest.fixture(autouse=True)
def _one_thread_each():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_overrides(workload):
    """Test-sized entries for ``workload``'s config, traffic and timing."""
    over = {'workload': {'warm_steps': 4, 'trace_steps': 1, 'warm_batches': 1,
                         'trace_batches': 1, 'trace_seconds': 0.3, 'patience_s': 30.0}}
    config = common.load_json('configs', workload['config'])
    traffic = common.load_json('traffic', workload['traffic'])
    if config['model_desc']['type'] == 'margipose':
        over['config'] = copy.deepcopy(SMALL_MARGIPOSE)
        size = 64
    else:
        over['config'] = {}
        size = 256
    if 'batch' in traffic:
        over['traffic'] = {'batch': 8 if workload['chips'] > 1 else 2, 'pool': 4,
                           'frame': [size, size]}
    else:
        over['traffic'] = {'pool': 8, 'rate': 40.0}
    return over


def small_context(name, seed=2**33 + 5, seconds=0.3, trace=False, **workload_entries):
    """A CPU context of cell ``name`` at test size."""
    workload = common.load_json('workloads', name)
    ctx = run.context(workload, seed, seconds, trace, torch.device('cpu'))
    over = small_overrides(workload)
    over['workload'].update(workload_entries)
    run.apply_overrides(ctx, over)
    return ctx
