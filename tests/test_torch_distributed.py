"""The port's multi-process data parallelism on the CPU, against the
single-process port and the JAX package's shard_map step.

Two gloo processes (``tests/torch_dist_workers.py``) stand in for two GPUs:

* the port's ``BatchNorm2d`` in train mode, each process holding half the
  batch: outputs, input gradients, the sum of the processes' parameter
  gradients and the running stats equal the single-process module's over the
  whole batch, to float32 noise (the global path computes flax's one-pass
  variance, E[x^2] - E[x]^2, where the single-process path is torch's; 1e-5
  relative at these magnitudes);
* a DistributedDataParallel train step at global batch 4 with both 2D rows
  (and more masked joints) on process 0, against the JAX package's
  ``make_train_step`` under ``jax.shard_map`` on a 2-device virtual mesh,
  with ``tests/test_torch_train_step.py``'s tolerances. The mean of the
  processes' own masked means would weight process 0's joints wrong; the
  global masked mean is what JAX computes.

Without a process group the modules compute what they did before (the
other test files hold that).
"""

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import margipose_tpu.train.steps as jax_steps
from margipose_tpu.parallel import make_mesh, shard_batch, shard_variables
from margipose_tpu.train.schedules import make_optimiser as jax_make_optimiser
from margipose_tpu_torch.models.layers import BatchNorm2d
from margipose_tpu_torch.parallel import mesh
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_train_step import SCHEDULE, _assert_state_matches, _batch, _torch_batch
from test_torch_weights import jax_margipose, small_desc
from torch_dist_workers import batch_norm_worker, spawn_gloo, train_step_worker

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


def test_no_group_in_the_test_process():
    assert not mesh.group_active()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.broadcast_object({'a': 1}) == {'a': 1}
    mesh.barrier()  # a no-op


@pytest.mark.parametrize('pc', [1, 2, 4])
def test_host_local_slices_partition_the_batch(pc):
    rows = []
    for pi in range(pc):
        rows.extend(range(16)[mesh.host_local_slice(16, process_index=pi, process_count=pc)])
    assert rows == list(range(16))


def test_global_batch_norm_equals_one_process_over_the_whole_batch(tmp_path):
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4, 6, 5, 5) * 2 + 1).astype(np.float32))
    upstream = torch.from_numpy(rng.randn(4, 6, 5, 5).astype(np.float32))
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.randn(6).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
    state = {k: v.clone() for k, v in bn.state_dict().items()}

    spawn_gloo(batch_norm_worker, 2, tmp_path, x, upstream, state, str(tmp_path))
    ranks = [torch.load(tmp_path / f'bn{r}.pt') for r in range(2)]

    xs = x.clone().requires_grad_()
    out = bn.train()(xs)
    (out * upstream).sum().backward()
    close = dict(rtol=1e-5, atol=1e-5)
    assert_allclose(torch.cat([r['out'] for r in ranks]).numpy(), out.detach().numpy(), **close)
    assert_allclose(torch.cat([r['grad_x'] for r in ranks]).numpy(), xs.grad.numpy(), **close)
    assert_allclose(sum(r['grad_w'] for r in ranks).numpy(), bn.weight.grad.numpy(), **close)
    assert_allclose(sum(r['grad_b'] for r in ranks).numpy(), bn.bias.grad.numpy(), **close)
    for key, value in bn.state_dict().items():
        assert torch.equal(ranks[0]['buffers'][key], ranks[1]['buffers'][key]), key
        assert_allclose(ranks[0]['buffers'][key].numpy(), value.numpy(), rtol=1e-6, atol=1e-7,
                        err_msg=key)


def _uneven_batch(seed):
    """Global batch 4: rows 0-1 (process 0) are 2D rows with 5 masked
    joints, rows 2-3 (process 1) 3D rows with one masked joint."""
    a, b = _batch(seed), _batch(seed + 1)
    batch = {k: np.concatenate([a[k], b[k]]) for k in a}
    batch['valid_depth'] = np.array([0, 0, 1, 1], np.int32)
    batch['joint_mask'][:] = 1
    batch['joint_mask'][0, [1, 4, 9]] = 0
    batch['joint_mask'][1, [2, 6]] = 0
    batch['joint_mask'][3, 12] = 0
    return batch


def test_ddp_train_step_matches_jax_shard_map(tmp_path):
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=4)
    batch = _uneven_batch(seed=21)

    jax_mesh = make_mesh(jax.devices()[:2])
    assert jax_steps.shard_map_axis(jax_mesh) == 'data'
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    jax_state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
    jax_state = jax_state.replace(params=shard_variables(jax_state.params, jax_mesh),
                                  batch_stats=shard_variables(jax_state.batch_stats, jax_mesh))
    step = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False, mesh=jax_mesh)
    jax_state, jax_metrics = step(jax_state, shard_batch(batch, jax_mesh))
    expected = state_dict_from_jax(jax.tree.map(np.asarray, {
        'params': jax_state.params, 'batch_stats': jax_state.batch_stats}))

    spawn_gloo(train_step_worker, 2, tmp_path, desc, state_dict_from_jax(variables),
               _torch_batch(batch), SCHEDULE, str(tmp_path))
    ranks = [torch.load(tmp_path / f'step{r}.pt') for r in range(2)]
    assert all(r['ddp'] for r in ranks)
    for key, value in ranks[0]['model'].items():
        assert torch.equal(value, ranks[1]['model'][key]), key
    assert float(ranks[0]['loss']) == float(ranks[1]['loss'])
    assert_allclose(float(ranks[0]['loss']), float(jax_metrics['loss']), rtol=1e-4)
    assert_allclose(torch.cat([r['pred'] for r in ranks]).numpy(),
                    np.asarray(jax_metrics['pred']), atol=1e-4)
    _assert_state_matches(ranks[0]['model'], expected, state_dict_from_jax(variables))


def test_the_mean_of_per_process_means_is_not_the_global_mean():
    """The batch above is one where averaging each process's own masked mean
    (what DDP's gradient averaging alone would give) differs from the global
    masked mean: 29 unmasked joints on process 0, 33 on process 1."""
    mask = _uneven_batch(seed=21)['joint_mask']
    losses = np.random.RandomState(0).uniform(0, 1, mask.shape)
    per_rank = [(losses[r] * mask[r]).sum() / mask[r].sum() for r in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(per_rank) - (losses * mask).sum() / mask.sum()) > 1e-3
