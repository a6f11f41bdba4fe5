"""The port's train bin on the other models, on the CPU.

``margipose_tpu_torch.bin.train_3d.main --device cpu`` with a ResNet stem
grafted from an ImageNet backbone (``pretrained_stem``), and with the
``chatterbox_model`` preset (256 px, the only size Chatterbox runs at). A
Chatterbox desc with ``pretrained_stem`` set is held to the JAX bin's
outcome. (Beside tests/test_torch_train_bin.py, in a file of its own so
that the two run on separate test workers.)
"""

import json
import os

import numpy as np
import pytest
import torch

import margipose_tpu_torch.bin.train_3d as train_3d
from margipose_tpu_torch.checkpoint import load_model
from test_torch_train_bin import _argv
from test_torch_weights import two_torch_threads  # noqa: F401

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures('two_torch_threads')


def _resnet34_backbone(path, seed=8):
    """A torchvision-format resnet34 state_dict from seeded tensors, with
    the deeper blocks and the classifier that a graft ignores."""
    from margipose_tpu_torch.models.resnet import ResNetStem

    gen = torch.Generator().manual_seed(seed)
    heads = {'0': 'conv1', '1': 'bn1', '4': 'layer1', '5': 'layer2'}
    backbone = {f"{heads[key.split('.')[0]]}.{key.partition('.')[2]}":
                (value if value.dtype == torch.int64 else torch.randn(value.shape, generator=gen))
                for key, value in ResNetStem('resnet34').state_dict().items()}
    backbone['layer3.0.conv1.weight'] = torch.randn(256, 128, 3, 3, generator=gen)
    backbone['fc.weight'] = torch.randn(1000, 512, generator=gen)
    torch.save(backbone, path)
    return backbone


def test_pretrained_stem_grafts_the_backbone(tmp_path, monkeypatch):
    """pretrained_stem: a resnet34 MargiPose starts from the backbone's
    conv1/bn1/layer1/layer2, and from its seeded initialisation elsewhere."""
    backbone = _resnet34_backbone(tmp_path / 'resnet34.pth')
    seen = {}

    def capture(cfg, state, *args, **kwargs):
        seen.update({k: v.clone() for k, v in state.model.state_dict().items()})
        raise KeyboardInterrupt

    monkeypatch.setattr(train_3d, 'do_training_pass', capture)
    desc = "model_desc={'settings': {'n_stages': 1, 'input_size': 64, 'feature_extractor': 'resnet34'}}"
    argv = _argv(str(tmp_path), desc, f"pretrained_stem='{tmp_path / 'resnet34.pth'}'")
    with pytest.raises(KeyboardInterrupt):
        train_3d.main(argv)
    heads = {'conv1': '0', 'bn1': '1', 'layer1': '4', 'layer2': '5'}
    grafted = 0
    for key, value in backbone.items():
        head, _, rest = key.partition('.')
        if head in heads and not key.endswith('num_batches_tracked'):
            assert torch.equal(seen[f'inner.in_cnn.{heads[head]}.{rest}'], value), key
            grafted += 1
    assert grafted == 80  # conv1, bn1 and the 7 blocks of layer1-2, num_batches_tracked aside
    fresh = train_3d.create_model(train_3d.ex.parse(argv[2:])['model_desc'],
                                  generator=torch.Generator().manual_seed(3)).state_dict()
    for key in ('inner.xy_hm_cnns.0.down_layers.0.module.0.weight',
                'inner.xz_hm_cnns.0.up_layers.4.shortcut.0.weight'):
        assert torch.equal(seen[key], fresh[key]), key


def test_pretrained_stem_on_chatterbox_raises_as_the_jax_bin_does(tmp_path):
    """Chatterbox has no feature_extractor setting, so both bins graft an
    inceptionv4 backbone, whose blocks match no key of its ResNet-34 stem:
    both raise the same ValueError before any step."""
    from margipose_tpu.bin import train_3d as jax_train_3d

    path = tmp_path / 'resnet34.pth'
    _resnet34_backbone(path)
    words = ['with', 'chatterbox_model', 'synthetic', 'epochs=1', 'batch_size=8',
             'train_examples=8', 'val_examples=8', 'num_workers=0',
             "train_datasets=['synthetic-4']", "val_datasets=['synthetic-2@1']",
             f'out_dir={tmp_path}', 'experiment_id=cb', f"pretrained_stem='{path}'"]
    with pytest.raises(ValueError, match='no stem leaves matched') as jax_error:
        jax_train_3d.run_training(jax_train_3d.ex.parse(words[1:]))
    with pytest.raises(ValueError, match='no stem leaves matched') as port_error:
        train_3d.main(['--device', 'cpu'] + words)
    assert str(port_error.value) == str(jax_error.value)


def test_chatterbox_model_preset_trains(tmp_path):
    """The chatterbox_model preset (256 px, the only size it runs at): one
    step at batch 2 and a validation batch, and a checkpoint that loads as a
    Chatterbox. The preset's desc is the JAX bin's: the default MargiPose
    settings merged in (n_stages among them), which Chatterbox ignores."""
    from margipose_tpu.bin import train_3d as jax_train_3d
    from margipose_tpu_torch.models.chatterbox import ChatterboxModel

    assert (train_3d.ex.parse(['with', 'chatterbox_model'])['model_desc']
            == jax_train_3d.ex.parse(['with', 'chatterbox_model'])['model_desc'])

    result = train_3d.main(['--device', 'cpu', 'with', 'chatterbox_model', 'synthetic',
                            'epochs=1', 'batch_size=2', 'train_examples=2', 'val_examples=2',
                            'num_workers=0', 'metrics_every=1', "train_datasets=['synthetic-4']",
                            "val_datasets=['synthetic-2@1']", f'out_dir={tmp_path}',
                            'experiment_id=cb'])
    assert result['step'] == 1 and np.isfinite(result['train_loss'])
    model, desc = load_model(os.path.join(str(tmp_path), 'cb', 'model-latest'), 'cpu')
    assert isinstance(model, ChatterboxModel) and desc['type'] == 'chatterbox'
    with open(os.path.join(str(tmp_path), 'cb', 'metrics.jsonl')) as f:
        assert np.isfinite(json.loads(f.readline())['val_loss'])
