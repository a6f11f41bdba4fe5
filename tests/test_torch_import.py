"""Checkpoint conversion: key mapping, weight layout, and numeric parity.

Numeric parity is verified end-to-end against a torch twin of the
HeatmapColumn (built here from the published architecture spec: 5 residual
blocks down with a stride-2 block, 5 up with a transposed-conv block;
reference: src/margipose/models/margipose_model.py:43-100). The twin
exercises every conversion rule: conv OIHW, transposed-conv IOHW,
batch-norm stats, and the torch Sequential naming scheme.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch import nn

from margipose_tpu.models.margipose import HeatmapColumn, MargiPoseModel
from margipose_tpu.train.torch_import import (
    convert_state_dict,
    flax_path_to_torch_key,
)

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


def _torch_res_block(in_ch, out_ch, kind):
    """Torch residual block with the reference's Sequential layout
    (module.0/1/3/4 + shortcut.0/1)."""
    if kind == 'regular':
        conv_in = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        sc_in = nn.Conv2d(in_ch, out_ch, 1, bias=False)
    elif kind == 'down':
        conv_in = nn.Conv2d(in_ch, out_ch, 3, padding=1, stride=2, bias=False)
        sc_in = nn.Conv2d(in_ch, out_ch, 1, stride=2, bias=False)
    elif kind == 'up':
        conv_in = nn.ConvTranspose2d(in_ch, out_ch, 3, padding=1, stride=2,
                                     output_padding=1, bias=False)
        sc_in = nn.ConvTranspose2d(in_ch, out_ch, 1, stride=2, output_padding=1,
                                   bias=False)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.module = nn.Sequential(
                conv_in, nn.BatchNorm2d(out_ch), nn.ReLU(),
                nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
                nn.BatchNorm2d(out_ch), nn.ReLU(),
            )
            self.shortcut = nn.Sequential(sc_in, nn.BatchNorm2d(out_ch))

        def forward(self, x):
            return self.module(x) + self.shortcut(x)

    return Block()


class TorchColumn(nn.Module):
    def __init__(self, n_joints, space):
        super().__init__()
        self.space = space
        self.down_layers = nn.Sequential(
            _torch_res_block(128, 128, 'regular'),
            _torch_res_block(128, 128, 'regular'),
            _torch_res_block(128, 192, 'down'),
            _torch_res_block(192, 192, 'regular'),
            _torch_res_block(192, 192, 'regular'),
        )
        self.up_layers = nn.Sequential(
            _torch_res_block(192, 192, 'regular'),
            _torch_res_block(192, 192, 'regular'),
            _torch_res_block(192, 128, 'up'),
            _torch_res_block(128, 128, 'regular'),
            _torch_res_block(128, n_joints, 'regular'),
        )

    def forward(self, x):
        mid = self.down_layers(x)
        size = mid.shape[-1]
        if self.space == 'zy':
            mid = torch.cat([t.permute(0, 3, 2, 1) for t in mid.split(size, -3)], -3)
        elif self.space == 'xz':
            mid = torch.cat([t.permute(0, 2, 1, 3) for t in mid.split(size, -3)], -3)
        return self.up_layers(mid)


def _randomize_bn_stats(module):
    rng = np.random.RandomState(7)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.from_numpy(
                rng.randn(m.num_features).astype(np.float32) * 0.1))
            m.running_var.copy_(torch.from_numpy(
                np.abs(rng.randn(m.num_features).astype(np.float32)) + 0.5))


@pytest.mark.parametrize('space', ['xy', 'zy'])
def test_heatmap_column_parity(space):
    torch.manual_seed(0)
    tcol = TorchColumn(17, space).eval()
    with torch.no_grad():
        _randomize_bn_stats(tcol)

    jcol = HeatmapColumn(17, heatmap_space=space)
    template = jcol.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 128)))
    variables = convert_state_dict(template, tcol.state_dict())

    x = np.random.RandomState(3).randn(2, 128, 32, 32).astype(np.float32)
    with torch.no_grad():
        expected = tcol(torch.from_numpy(x)).numpy()
    actual = jcol.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    actual = np.asarray(actual).transpose(0, 3, 1, 2)
    assert_allclose(actual, expected, atol=2e-4)


def test_full_model_key_mapping_structural():
    """Every flax leaf of the flagship model maps to a unique torch key with
    the reference naming scheme; a synthetic state_dict with those exact keys
    converts cleanly."""
    model = MargiPoseModel(n_joints=17, n_stages=2, feature_extractor='inceptionv4')
    template = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))

    from margipose_tpu.train.torch_import import _flatten, flax_path_to_torch_keys

    keys = {}
    for collection, tree in template.items():
        for path, value in _flatten(tree):
            tkeys = flax_path_to_torch_keys(path)
            shape = np.asarray(value).shape
            if len(tkeys) > 1:  # vmapped column leaf: [3, ...] -> per-plane
                assert shape[0] == len(tkeys)
                shape = shape[1:]
            for key in tkeys:
                # params and batch_stats never collide except BN weight/bias
                # vs stats, which have distinct torch names
                assert key not in keys, f'duplicate torch key {key}'
                keys[key] = (collection, path, shape)

    # spot-check known reference key spellings
    expected_samples = [
        'inner.in_cnn.0.conv.weight',
        'inner.in_cnn.3.conv.conv.weight',
        'inner.in_cnn.4.branch1.2.conv.weight',
        'inner.in_cnn.6.branch3.1.bn.running_var',
        'inner.in_cnn.7.weight',
        'inner.in_cnn.8.running_mean',
        'inner.hm_combiners.0.conv.weight',
        'inner.xy_hm_cnns.1.down_layers.2.module.0.weight',
        'inner.zy_hm_cnns.0.up_layers.2.shortcut.0.weight',
        'inner.xz_hm_cnns.1.up_layers.4.module.3.weight',
    ]
    for k in expected_samples:
        assert k in keys, f'missing expected torch key {k}'

    # build a synthetic torch state_dict and convert it
    sd = {}
    for key, (collection, path, shape) in keys.items():
        if path[-1] == 'weight' and len(shape) == 4:
            kh, kw, cin, cout = shape
            if 'up_layers.2' in key and key.endswith('.0.weight'):
                arr = np.random.randn(cin, cout, kh, kw)  # torch IOHW
            else:
                arr = np.random.randn(cout, cin, kh, kw)  # torch OIHW
        else:
            arr = np.random.randn(*shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))

    variables = convert_state_dict(template, sd)
    assert set(variables.keys()) == set(template.keys())

    # round-trip value check on a conv and a transposed conv
    w = np.asarray(variables['params']['inner']['in_cnn']['0']['conv']['weight'])
    assert_allclose(w, sd['inner.in_cnn.0.conv.weight'].numpy().transpose(2, 3, 1, 0))


def test_convert_rejects_missing_and_extra_keys():
    model = HeatmapColumn(4, heatmap_space='xy')
    template = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 128)))
    tcol = TorchColumn(4, 'xy')
    sd = tcol.state_dict()
    missing = dict(sd)
    missing.pop('down_layers.0.module.0.weight')
    with pytest.raises(KeyError):
        convert_state_dict(template, missing)
    extra = dict(sd)
    extra['bogus.weight'] = torch.zeros(1)
    with pytest.raises(ValueError):
        convert_state_dict(template, extra)


@pytest.mark.slow  # 39s measured (r4 durations profile)
def test_chatterbox_state_dict_roundtrip():
    """export_state_dict / convert_state_dict are mutual inverses on the
    Chatterbox tree too — exercises the chatterbox-specific key mappings
    (down_N/up_N sequential indices, resample shortcuts) and the
    transposed-conv IOHW flip patterns in both directions
    (reference: src/margipose/models/chatterbox_model.py:86-220)."""
    import jax
    import jax.numpy as jnp

    from margipose_tpu.models import Default_Chatterbox_Desc, create_model
    from margipose_tpu.train.torch_import import (
        convert_state_dict,
        export_state_dict,
    )

    model = create_model(Default_Chatterbox_Desc)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3), jnp.float32))
    variables = jax.tree.map(np.asarray, dict(variables))

    sd = export_state_dict(variables)
    # transposed-conv keys really take the torch IOHW layout (I, O, kh, kw)
    up0 = sd['zy_hm_cnn.up_convs.0.weight']
    flax_up0 = variables['params']['zy_hm_cnn']['up_0']['weight']
    assert up0.shape == (flax_up0.shape[2], flax_up0.shape[3],
                         flax_up0.shape[0], flax_up0.shape[1])

    template = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)))
    reimported = convert_state_dict(dict(template), sd)
    flat_a = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(variables)[0]}
    flat_b = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(reimported)[0]}
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]),
                                      np.asarray(flat_b[k]), err_msg=k)
