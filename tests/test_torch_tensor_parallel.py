"""The port's hybrid ('data', 'model') mesh on the CPU, against the JAX
package's sharding rule, its GSPMD step and its single-device step, and
against the port's own single-process step.

gloo processes (``tests/torch_dist_workers.py``, one thread each) stand in
for GPUs. The model is the small flagship (``test_torch_weights.jax_margipose``:
2 stages, 64 px, calibrated), exported into the port through
``state_dict_from_jax``; the global batch is ``test_torch_distributed``'s
uneven batch of 4 (two 2D rows with more masked joints on data coordinate
0). A ``(d, m)`` mesh puts rank r at ``(r // m, r % m)``: the m processes of
a data coordinate load the same rows, and each holds its slice of every
sharded convolution's output channels.

Tolerances, float32 on the CPU:
  loss, predictions, parameters and BN buffers against JAX: those of
      ``tests/test_torch_train_step.py`` (loss rtol 1e-4, predictions atol
      1e-4, each parameter within 1e-4 + 2% of the largest update JAX's step
      made to it, running stats rtol 1e-4 atol 1e-5): the sharded step sums
      in another order, as any port step does;
  against JAX's GSPMD step on a (2, 2) mesh: the parameter rule doubled,
      2e-4 + 4% of the update (the rest as above). JAX's own GSPMD step
      lies 1.89 times the rule from its single-device step on this model
      and batch (measured): GSPMD partitions the convolutions' sums too;
  the input image's gradient against the port's single process: within 2%
      of its largest element. The global batch norm's one-pass variance
      (``models/layers.BatchNorm2d``, which every multi-process step runs,
      the pure data-parallel step's too) puts the pure-data mesh (2, 1) 1.28%
      of it from the single process, and the hybrid meshes as far;
      (2, 2) against (2, 1), whose processes hold the same rows and sum the
      same batch-norm statistics: within 1e-4 of its largest element (1e-6
      measured), only the convolutions' channel split and the 'model'
      all-reduce reorder. A missing all-reduce leaves the gradient off by
      about its own size;
  eval loss and predictions against one process: rtol 1e-5 / atol 1e-5
      (eval-mode batch norm, no gradient: only the convolutions' and the
      loss's sums reorder);
  a checkpoint written under (2, 2) against one process's step: the
      parameter rule above, and the same rule on the update the momentum
      makes (lr times the buffer, which after one step is the gradient).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch import nn

import margipose_tpu.train.steps as jax_steps
from margipose_tpu.models import create_model as create_jax_model
from margipose_tpu.parallel import make_mesh as jax_make_mesh
from margipose_tpu.parallel import param_shardings as jax_param_shardings
from margipose_tpu.parallel import shard_batch as jax_shard_batch
from margipose_tpu.parallel import shard_variables as jax_shard_variables
from margipose_tpu.train.schedules import make_optimiser as jax_make_optimiser
from margipose_tpu_torch.models import Default_MargiPose_Desc, create_model
from margipose_tpu_torch.models.chatterbox import Default_Chatterbox_Desc
from margipose_tpu_torch.parallel import mesh
from margipose_tpu_torch.train.checkpoint import load_payload
from margipose_tpu_torch.train.schedules import make_optimiser, schedule_values
from margipose_tpu_torch.train.steps import TrainState, make_eval_step, make_train_step
from margipose_tpu_torch.weights import state_dict_from_jax
from test_torch_distributed import _uneven_batch
from test_torch_train_step import SCHEDULE, _assert_state_matches, _torch_batch
from test_torch_weights import jax_margipose, small_desc
from torch_dist_workers import in_turn, spawn_gloo, tensor_parallel_worker, train_step_worker

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

GRAD_INPUT_SHARE = 2e-2     # of the gradient's largest element, against one process
GRAD_INPUT_TP_SHARE = 1e-4  # the same, (2, 2) against the pure-data mesh (2, 1)
GSPMD_RULE_SCALE = 2        # the parameter rule's scale against JAX's GSPMD step


@functools.lru_cache
def _jax_variable_shapes(model_type):
    """The JAX model's variables as shapes (``jax.eval_shape`` of its init at
    256 px): no weights made."""
    desc = {'margipose': Default_MargiPose_Desc, 'chatterbox': Default_Chatterbox_Desc}[model_type]
    return jax.eval_shape(create_jax_model(desc).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 256, 256, 3), np.float32))


def _jax_sharded_keys(desc, m):
    """The port's state_dict keys of the weights JAX's ``param_shardings``
    shards over a model axis of ``m`` devices, for ``desc``'s model: each
    variable marked 1 or 0 by its spec and mapped through
    ``state_dict_from_jax`` (a vmapped column stack's leaf becomes its three
    columns' keys)."""
    shapes = _jax_variable_shapes(desc['type'])
    grid = jax_make_mesh(jax.devices()[:m], shape=(1, m))
    shardings = jax_param_shardings(grid, shapes)
    marks = jax.tree.map(lambda s, v: np.broadcast_to(np.uint8('model' in s.spec), v.shape),
                         shardings, shapes)
    return {k for k, v in state_dict_from_jax(marks).items() if v.dtype == torch.uint8
            and v.numel() and bool(v.flatten()[0])}


@pytest.mark.parametrize('m', [1, 2, 4])
@pytest.mark.parametrize('desc,convs,sharded', [
    (Default_MargiPose_Desc, 382, 346), (Default_Chatterbox_Desc, 83, 80)],
    ids=['flagship', 'chatterbox'])
def test_the_rule_shards_what_jax_shards(desc, convs, sharded, m):
    """At full width, on the meta device (no weights made): the port's
    ``param_shardings`` shards exactly the weights JAX's shards, every one of
    them a convolution's output channels."""
    with torch.device('meta'):
        model = create_model(desc)
    grid = mesh.Mesh(shape={'data': 1, 'model': m}, coords={'data': 0, 'model': 0})
    specs = mesh.param_shardings(grid, model)
    ours = {k for k, dim in specs.items() if dim is not None}
    assert set(specs) == set(model.state_dict())
    assert ours == _jax_sharded_keys(desc, m)
    conv_modules = {name: c for name, c in model.named_modules()
                    if isinstance(c, (nn.Conv2d, nn.ConvTranspose2d))}
    assert len(conv_modules) == convs
    assert len(ours) == (0 if m == 1 else sharded)
    for key in ours:
        conv = conv_modules[key[:-len('.weight')]]
        assert specs[key] == (1 if isinstance(conv, nn.ConvTranspose2d) else 0)


def test_the_sharded_dim_follows_the_module_type():
    """A transposed convolution's output channels are weight dim 1 in torch:
    ConvTranspose2d(6, 4) shards dim 1 at m = 2 (where dim 0 would also
    divide), ConvTranspose2d(4, 3) nothing (dim 0 would divide, dim 1 does
    not); a 4D parameter outside a convolution, or a grouped convolution,
    is replicated."""
    assert mesh._param_spec(nn.ConvTranspose2d(6, 4, 3), 2) == 1
    assert mesh._param_spec(nn.ConvTranspose2d(4, 3, 3), 2) is None
    assert mesh._param_spec(nn.Conv2d(3, 4, 3), 2) == 0
    assert mesh._param_spec(nn.Conv2d(3, 2, 3), 2) is None  # out_ch < 2m
    assert mesh._param_spec(nn.Conv2d(3, 4, 3), 1) is None
    assert mesh._param_spec(nn.Conv2d(4, 4, 3, groups=2), 2) is None
    assert mesh._param_spec(nn.BatchNorm2d(4), 2) is None


@pytest.mark.parametrize('d,m', [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)])
def test_host_local_slice_follows_the_data_coordinate(d, m):
    """Model peers load the same rows; the data coordinates partition the
    batch in order; ``shard_batch`` takes those rows and
    ``host_local_values`` gives them back."""
    batch = {'x': torch.arange(8.0)}
    rows = []
    for rank in range(d * m):
        grid = mesh.Mesh(shape={'data': d, 'model': m}, coords={'data': rank // m,
                                                               'model': rank % m})
        local = mesh.shard_batch(batch, grid)
        assert local['x'].tolist() == list(range(8))[mesh.host_local_slice(8, mesh=grid)]
        if grid.coords['model'] == 0:
            rows.extend(mesh.host_local_values(local['x']).tolist())
    assert rows == list(range(8))


def test_make_mesh_without_a_group_is_one_process():
    grid = mesh.make_mesh()
    assert grid == mesh.Mesh(shape={'data': 1, 'model': 1}, coords={'data': 0, 'model': 0})
    with pytest.raises(ValueError):
        mesh.make_mesh((2, 1))


@pytest.fixture(scope='module')
def calibrated():
    desc = small_desc()
    jax_model, variables = jax_margipose(desc, seed=4)
    return desc, jax_model, variables, _uneven_batch(seed=21)


@pytest.fixture(scope='module')
def jax_single(calibrated):
    """JAX's single-device step on the whole batch, as a state_dict."""
    desc, jax_model, variables, batch = calibrated
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
    step = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False)
    state, metrics = step(state, jax.tree.map(jax.numpy.asarray, batch))
    return _jax_result(state, metrics)


def _jax_result(state, metrics):
    return {'model': state_dict_from_jax(jax.tree.map(np.asarray, {
        'params': state.params, 'batch_stats': state.batch_stats})),
        'loss': float(metrics['loss']), 'pred': np.asarray(metrics['pred'])}


@pytest.fixture(scope='module')
def port_single(calibrated):
    """The port's single-process train step on the whole batch (with the
    input's gradient) and its eval step, from the same weights."""
    desc, _, variables, batch = calibrated
    model = create_model(desc)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = TrainState(model, make_optimiser('1cycle', model.parameters(), 1.0, **SCHEDULE))
    tb = _torch_batch(batch)
    evaluated = make_eval_step('jsd')(model, tb)
    tb['input'] = tb['input'].clone().requires_grad_()
    metrics = make_train_step('jsd')(state, tb)
    return {'model': model.state_dict(), 'loss': float(metrics['loss']),
            'grad_input': tb['input'].grad, 'eval': evaluated,
            'momentum': [s['momentum_buffer'] for s in
                         state.optimiser.state_dict()['optimiser']['state'].values()]}


def _spawn(world, tmp_path, calibrated, jobs):
    desc, _, variables, batch = calibrated
    args = (desc, state_dict_from_jax(variables), _torch_batch(batch), SCHEDULE, str(tmp_path))
    spawn_gloo(in_turn, world, tmp_path, [(fn, extra + args + tail) for fn, extra, tail in jobs])


@pytest.fixture(scope='module')
def two_processes(calibrated, tmp_path_factory):
    """Two processes, in one process group: the DDP step of
    ``test_torch_distributed.py``, the default mesh's step (2, 1), the (1,
    2) mesh's, and the (1, 2) mesh's with the planted fault."""
    tmp = tmp_path_factory.mktemp('tp2')
    _spawn(2, tmp, calibrated, [(train_step_worker, (), ()),
                                (tensor_parallel_worker, (None,), ()),
                                (tensor_parallel_worker, ((1, 2),), ()),
                                (tensor_parallel_worker, ((1, 2),), ('model_all_reduce',))])
    return {'ddp': [torch.load(tmp / f'step{r}.pt') for r in range(2)],
            **{key: [torch.load(tmp / f'{name}-{r}.pt') for r in range(2)]
               for key, name in (((2, 1), '2x1'), ((1, 2), '1x2'),
                                 ('fault', '1x2-model_all_reduce'))}}


@pytest.fixture(scope='module')
def four_processes(calibrated, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp4')
    _spawn(4, tmp, calibrated, [(tensor_parallel_worker, ((2, 2),), ())])
    return {'ranks': [torch.load(tmp / f'2x2-{r}.pt') for r in range(4)],
            'checkpoint': load_payload(str(tmp / 'ckpt-2x2'))}


@pytest.fixture
def hybrid(request):
    if request.param == (1, 2):
        return request.getfixturevalue('two_processes')[(1, 2)]
    return request.getfixturevalue('four_processes')['ranks']


def _grad_input(ranks):
    """The global batch's input gradient from each data coordinate's first
    model peer, divided by d: the loss's all-reduce scales a process's
    input gradient by the data axis's size (``train/steps.py``)."""
    d, m = ranks[0]['shape']['data'], ranks[0]['shape']['model']
    return torch.cat([ranks[i * m]['grad_input'] for i in range(d)]) / d


def _assert_grad_input_close(got, want):
    assert_allclose(got.numpy(), want.numpy(), rtol=0,
                    atol=GRAD_INPUT_SHARE * want.abs().max().item())


def _assert_ranks_agree(ranks):
    """Every process's gathered state equal; the sharded weights' local
    slices 1/m of the full ones."""
    m = ranks[0]['shape']['model']
    for r in ranks[1:]:
        assert r['digest'] == ranks[0]['digest']
        assert float(r['loss']) == float(ranks[0]['loss'])
    for key, dim in ranks[0]['shardings'].items():
        full = tuple(ranks[0]['model'][key].shape)
        local = ranks[0]['local_shapes'][key]
        assert local == (full if dim is None else full[:dim] + (full[dim] // m,) + full[dim + 1:])


@pytest.mark.parametrize('hybrid', [(1, 2), (2, 2)], indirect=True, ids=['1x2', '2x2'])
def test_hybrid_train_step_matches_jax_single_device(hybrid, jax_single, calibrated):
    """The loss, predictions, parameters and BN buffers of the hybrid step
    against JAX's single-device step, as GSPMD's step equals it; DDP only
    where d > 1; ranks laid out as JAX lays out devices."""
    ranks = hybrid
    d, m = ranks[0]['shape']['data'], ranks[0]['shape']['model']
    assert [r['coords'] for r in ranks] == [{'data': i // m, 'model': i % m}
                                            for i in range(d * m)]
    assert all(r['ddp'] == (d > 1) for r in ranks)
    assert sum(dim is not None for dim in ranks[0]['shardings'].values()) == 182
    _assert_ranks_agree(ranks)
    assert_allclose(float(ranks[0]['loss']), jax_single['loss'], rtol=1e-4)
    assert_allclose(torch.cat([ranks[i * m]['pred'] for i in range(d)]).numpy(),
                    jax_single['pred'], atol=1e-4)
    _assert_state_matches(ranks[0]['model'], jax_single['model'],
                          state_dict_from_jax(calibrated[2]))


@pytest.mark.parametrize('hybrid', [(1, 2), (2, 2)], indirect=True, ids=['1x2', '2x2'])
def test_hybrid_input_gradient_matches_one_process(hybrid, port_single):
    _assert_grad_input_close(_grad_input(hybrid), port_single['grad_input'])


def test_hybrid_input_gradient_matches_the_pure_data_mesh(two_processes, four_processes):
    want = _grad_input(two_processes[(2, 1)])
    assert_allclose(_grad_input(four_processes['ranks']).numpy(), want.numpy(), rtol=0,
                    atol=GRAD_INPUT_TP_SHARE * want.abs().max().item())


@pytest.mark.slow  # 23.5 s on one thread, of which JAX's hybrid compile most
def test_hybrid_train_step_matches_jax_gspmd(four_processes, calibrated):
    """The (2, 2) step against the JAX package's own hybrid step: GSPMD on a
    (2, 2) mesh of four virtual CPU devices, conv kernels sharded on their
    output features (``margipose_tpu/train/steps.py``, ``shard_map_axis``
    None)."""
    desc, jax_model, variables, batch = calibrated
    grid = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    assert jax_steps.shard_map_axis(grid) is None
    tx = jax_make_optimiser('1cycle', 1.0, **SCHEDULE)
    state = jax_steps.create_train_state(jax_model, None, tx, variables=variables)
    state = state.replace(params=jax_shard_variables(state.params, grid),
                          batch_stats=jax_shard_variables(state.batch_stats, grid),
                          opt_state=jax.device_put(state.opt_state))
    step = jax_steps.make_train_step(jax_model, tx, 'jsd', donate=False, mesh=grid)
    state, metrics = step(state, jax_shard_batch(batch, grid))
    want = _jax_result(state, metrics)
    ranks = four_processes['ranks']
    assert_allclose(float(ranks[0]['loss']), want['loss'], rtol=1e-4)
    assert_allclose(torch.cat([ranks[0]['pred'], ranks[2]['pred']]).numpy(), want['pred'],
                    atol=1e-4)
    initial = state_dict_from_jax(variables)
    for key, value in want['model'].items():
        if 'running_' in key or key.endswith('num_batches_tracked'):
            continue
        update = np.abs(value.numpy() - initial[key].numpy()).max()
        assert_allclose(ranks[0]['model'][key].numpy(), value.numpy(), rtol=0,
                        atol=GSPMD_RULE_SCALE * (1e-4 + 0.02 * update), err_msg=key)
    _assert_state_matches({k: v for k, v in ranks[0]['model'].items()
                           if 'running_' in k or k.endswith('num_batches_tracked')},
                          {k: v for k, v in want['model'].items()
                           if 'running_' in k or k.endswith('num_batches_tracked')}, initial)


def test_hybrid_eval_step_matches_one_process(four_processes, port_single):
    ranks = four_processes['ranks']
    for r in ranks:
        assert_allclose(float(r['eval_loss']), float(port_single['eval']['loss']), rtol=1e-5)
    assert_allclose(torch.cat([ranks[0]['eval_pred'], ranks[2]['eval_pred']]).numpy(),
                    port_single['eval']['pred'].numpy(), atol=1e-5)


def test_checkpoint_from_the_hybrid_mesh_loads_into_the_plain_model(four_processes,
                                                                     port_single, calibrated):
    """The file holds the plain layout: it loads strictly into the plain
    model and its optimiser, and equals one process's step (the parameter
    rule, and the same rule on the momentum, which is the gradient after
    one step). Each process restored it into a sharded model through
    ``shard_variables`` and got its own weights and momentum back bit for
    bit."""
    desc, _, variables, _ = calibrated
    payload = four_processes['checkpoint']
    model = create_model(desc)
    model.load_state_dict(payload['model'], strict=True)
    optimiser = make_optimiser('1cycle', model.parameters(), 1.0, **SCHEDULE)
    optimiser.load_state_dict(payload['optimiser'])
    assert payload['step'] == 1 and optimiser.count == 1
    initial = state_dict_from_jax(variables)
    _assert_state_matches(payload['model'], port_single['model'], initial)
    lr, _ = schedule_values('1cycle', 1.0, 0, **SCHEDULE)
    got = [s['momentum_buffer'] for s in optimiser.state_dict()['optimiser']['state'].values()]
    assert len(got) == len(port_single['momentum'])
    for a, b in zip(got, port_single['momentum']):
        assert a.shape == b.shape
        assert_allclose(lr * a.numpy(), lr * b.numpy(), rtol=0,
                        atol=1e-4 + 0.02 * lr * b.abs().max().item())
    assert all(r['round_trip'] for r in four_processes['ranks'])


def test_a_missing_model_all_reduce_is_caught(two_processes, port_single):
    """The planted fault: the column-parallel layers' input gradient left a
    partial sum (the 'model' all-reduce dropped). The loss still matches;
    the input's gradient fails the check above."""
    ranks = two_processes['fault']
    assert_allclose(float(ranks[0]['loss']), port_single['loss'], rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_grad_input_close(_grad_input(ranks), port_single['grad_input'])


def test_the_default_mesh_is_the_pure_data_step(two_processes):
    """``make_mesh()`` over two processes is (2, 1): nothing sharded, DDP
    over every process, and the step ``test_torch_distributed.py``'s DDP
    step takes, bit for bit."""
    ddp, default = two_processes['ddp'], two_processes[(2, 1)]
    assert all(r['ddp'] for r in default)
    assert not any(dim is not None for dim in default[0]['shardings'].values())
    for r in range(2):
        assert float(default[r]['loss']) == float(ddp[r]['loss'])
        assert torch.equal(default[r]['pred'], ddp[r]['pred'])
    for key, value in ddp[0]['model'].items():
        assert torch.equal(default[0]['model'][key], value), key
    assert default[1]['digest'] == default[0]['digest']


