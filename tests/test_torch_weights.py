"""The port's weights bridge against the JAX package's exporter.

``margipose_tpu_torch.weights.state_dict_from_jax`` must give the same keys
and arrays as ``margipose_tpu.train.torch_import.export_state_dict``, and the
result must load into the port's model with ``strict=True``.

``jax_margipose`` makes the JAX model that the other ``test_torch_*`` files share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from margipose_tpu.models import create_model as create_jax_model
from margipose_tpu.train.torch_import import export_state_dict
from margipose_tpu_torch.models import create_model
from margipose_tpu_torch.weights import state_dict_from_jax, torch_keys


def small_desc(n_stages=2, axis_permutation=True, input_size=64):
    return {'type': 'margipose', 'version': '6.0.1',
            'settings': {'n_stages': n_stages, 'axis_permutation': axis_permutation,
                         'feature_extractor': 'inceptionv4', 'pixelwise_loss': 'jsd',
                         'input_size': input_size}}


def jax_margipose(desc, seed=0, calibrate=True, variables=None):
    """A randomly initialised JAX MargiPose as host numpy variables
    (``variables``, a tree of the model's shapes, in place of JAX's init).

    With ``calibrate``, the BN running stats are those of one train-mode pass
    on a random batch, then perturbed at random, and the last residual block
    of every column is scaled down so the heatmaps are neither flat nor one-hot
    (peaks of about 0.2-0.5). Untouched, the Kaiming-initialised residual
    stacks give logits so large that any float32 reordering shows in the
    softmax."""
    size = desc['settings'].get('input_size', 256)
    model = create_jax_model(desc)
    rng = np.random.RandomState(seed)
    if variables is None:
        variables = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3))))
    if not calibrate:
        return model, variables
    stats = jax.tree.map(np.zeros_like, variables['batch_stats'])
    x = rng.randn(2, size, size, 3).astype(np.float32)
    _, upd = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=['batch_stats']))(
        {'params': variables['params'], 'batch_stats': stats}, x)

    # from zeroed running stats, one update leaves 0.1 x the batch stats
    def perturb(path, new):
        new = np.asarray(new) / 0.1
        if path[-1].key == 'mean':
            return (new + 0.05 * rng.randn(*new.shape)).astype(np.float32)
        return (new * rng.uniform(0.8, 1.25, new.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(perturb, upd['batch_stats'])
    params = jax.tree.map(np.copy, variables['params'])
    for name, column in params['inner'].items():
        if name.startswith('hm_cnns_up_'):
            for branch, idx in (('module', '4'), ('shortcut', '1')):
                bn = column['4'][branch][idx]['BatchNorm_0']
                bn['scale'] = (bn['scale'] * 0.2).astype(np.float32)
                bn['bias'] = (bn['bias'] * 0.2 + 0.01 * rng.randn(*bn['bias'].shape)
                              ).astype(np.float32)
    return model, {'params': params, 'batch_stats': stats}


def port_init_as_jax(desc, seed=0, module=None, shape=None):
    """The port's seeded initialisation of ``desc``'s model (or of
    ``module``, a JAX module with its port counterpart, taking NHWC inputs
    of ``shape``) as a JAX variables tree, through the JAX package's
    importer: no JAX init to compile."""
    from margipose_tpu.train.torch_import import convert_state_dict

    if module is None:
        size = desc['settings'].get('input_size', 256)
        shape = (1, size, size, 3)
        module = (create_jax_model(desc),
                  create_model(desc, generator=torch.Generator().manual_seed(seed)))
    jax_module, port_module = module
    template = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    return convert_state_dict(template, port_module.state_dict())


@pytest.fixture
def two_torch_threads():
    """Two intra-op threads for torch during a test, then the number it had.
    The tier-1 command runs six test workers on the machine's cores; a file
    of full-width models keeps to two threads so that the workers do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_variables():
    return jax_margipose(small_desc(), calibrate=False)[1]


def test_state_dict_matches_jax_export(jax_variables):
    ours = state_dict_from_jax(jax_variables)
    ref = export_state_dict(jax_variables)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize('axis_permutation', [True, False])
def test_state_dict_loads_strict(jax_variables, axis_permutation):
    model = create_model(small_desc(axis_permutation=axis_permutation))
    sd = state_dict_from_jax(jax_variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    conv = model.inner.zy_hm_cnns[1].up_layers[2].module[0]
    assert isinstance(conv, torch.nn.ConvTranspose2d)
    np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                  sd['inner.zy_hm_cnns.1.up_layers.2.module.0.weight'].numpy())


def test_stacked_columns_split_into_planes():
    path = ('inner', 'hm_cnns_up_3', '2', 'module', '1', 'BatchNorm_0', 'mean')
    assert torch_keys(path) == [
        f'inner.{p}_hm_cnns.3.up_layers.2.module.1.running_mean' for p in ('xy', 'zy', 'xz')]
    assert torch_keys(('inner', 'hm_combiners_0', 'conv', 'weight')) == [
        'inner.hm_combiners.0.conv.weight']
    assert torch_keys(('inner', 'in_cnn', '0', 'bn', 'BatchNorm_0', 'scale')) == [
        'inner.in_cnn.0.bn.weight']


def test_transposed_conv_weights_round_trip():
    """A transposed-conv kernel stored flipped-HWIO comes back as torch's
    IOHW with the flip undone: the port's ConvTranspose2d on the exported
    weight equals the JAX conv2d_transpose on the stored one."""
    from margipose_tpu.ops.convs import conv2d_transpose

    rng = np.random.RandomState(0)
    w_hwio = rng.randn(3, 3, 5, 4).astype(np.float32)
    tree = {'params': {'inner': {'hm_cnns_up_0': {'2': {'module': {'0': {
        'weight': np.stack([w_hwio] * 3)}}}}}}}
    sd = state_dict_from_jax(tree)
    w = sd['inner.xz_hm_cnns.0.up_layers.2.module.0.weight']
    x = rng.randn(1, 4, 4, 5).astype(np.float32)
    expected = np.asarray(conv2d_transpose(x, w_hwio, stride=2, padding=1, output_padding=1))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2, padding=1, output_padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), expected, atol=1e-5)
