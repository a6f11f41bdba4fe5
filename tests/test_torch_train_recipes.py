"""The port's train bin on the real datasets' recipes, on the CPU.

Fake MPI-INF-3DHP train/val (S1/Seq1 and S2/Seq2, both bg/ub/lb-augmentable
in mpi3d_sequence_info.json, so compositing runs), Human3.6M and MPII
corpora stand in for the datasets. The ``mpi3d`` and ``h36m`` presets and
the bin's own default config (``mpi3d-trainval`` + ``mpii-trainval``) train
MargiPose (inceptionv4, 1 stage, 64 px) for two augmented steps at batch 2:
every batch mixes 3D and 2D examples and the losses are finite. The keys
this slice ports run through the bin. (The runs write no output directory:
its TensorBoard sink would import TensorFlow, which alone takes longer than
a run on the CPU.)
Eval and infer set cuDNN's deterministic algorithms even after a train run
in the same process left its timed search on, as the JAX bins do.
"""

import os

import numpy as np
import PIL.Image
import pytest
import torch

import margipose_tpu_torch.bin.eval_3d as eval_3d
import margipose_tpu_torch.bin.infer_single as infer_single
import margipose_tpu_torch.bin.train_3d as train_3d
from margipose_tpu_torch.checkpoint import save_model
from margipose_tpu_torch.data.fake_mpi3d import generate_fake_mpi3d
from margipose_tpu_torch.data.fakes import generate_fake_h36m, generate_fake_mpii
from margipose_tpu_torch.data.mpi_inf_3dhp import MpiInf3dDataset
from margipose_tpu_torch.models import create_model
from test_torch_weights import small_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESC = "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}"


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('datasets'))
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'train'), seqs=((1, 1),), camera_ids=(0,),
                        n_frames=3)
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'val'), seqs=((2, 2),), camera_ids=(0,),
                        n_frames=2, seed=1)
    generate_fake_mpi3d(os.path.join(base, 'mpi3d', 'test'), seqs=((1, 1),), camera_ids=(0,),
                        n_frames=2, with_activities=True, seed=2)
    generate_fake_h36m(os.path.join(base, 'h36m'), subjects=(1,), camera_ids=(1,), n_frames=3)
    generate_fake_mpii(os.path.join(base, 'mpii'), n_train=4, n_val=2)
    return base


@pytest.fixture(autouse=True)
def _environment(corpus, monkeypatch):
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', corpus)
    monkeypatch.setenv('MARGIPOSE_RESOURCES_DIR', os.path.join(ROOT, 'resources'))
    # the bin sets this class attribute from its config: restore it after
    monkeypatch.setattr(MpiInf3dDataset, 'preserve_root_joint_at_univ_scale', False)


def _argv(*words):
    return ['--device', 'cpu', 'with', *words, DESC, 'epochs=1', 'batch_size=2',
            'train_examples=4', 'val_examples=2', 'num_workers=0', 'metrics_every=1',
            "out_dir=''"]


@pytest.fixture
def batches_seen(monkeypatch):
    """The valid_depth of every host batch the train bin uploads."""
    seen = []
    real = train_3d.device_prefetch

    def recording(loader, *args, **kwargs):
        for batch, device_batch in real(loader, *args, **kwargs):
            seen.append(sorted(int(v) for v in batch['valid_depth']))
            yield batch, device_batch

    monkeypatch.setattr(train_3d, 'device_prefetch', recording)
    return seen


@pytest.mark.parametrize('preset', ['mpi3d', 'h36m', 'default'])
def test_dataset_recipes_train(preset, batches_seen):
    words = ['margipose_model'] + ([] if preset == 'default' else [preset])
    result = train_3d.main(_argv(*words))
    config = train_3d.ex.parse(words)
    expected = ['h36m-trainval' if preset == 'h36m' else 'mpi3d-trainval', 'mpii-trainval']
    assert config['train_datasets'] == expected and config['use_aug']
    assert result['step'] == 2 and np.isfinite(result['train_loss'])
    # round robin over a 3D source and MPII: each batch of 2 has one of each
    assert batches_seen == [[0, 1], [0, 1]]


@pytest.mark.parametrize('override', [
    "train_datasets=['mpi3d-train', 'mpii-train']",
    "val_datasets=['mpi3d-val', 'mpii-val']",
    'preserve_root_joint_at_univ_scale=True',
])
def test_keys_ported_in_this_slice_run(monkeypatch, override):
    """The keys that left NOT_PORTED run through the bin: several train or
    validation datasets, and the universal-scale root option, which reaches
    MpiInf3dDataset as in the JAX bin."""
    seen = []
    real_getitem = MpiInf3dDataset.__getitem__

    def recording(self, index):
        seen.append(self.preserve_root_joint_at_univ_scale)
        return real_getitem(self, index)

    monkeypatch.setattr(MpiInf3dDataset, '__getitem__', recording)
    result = train_3d.main(_argv('margipose_model', "train_datasets=['mpi3d-train']",
                                 "val_datasets=['mpi3d-val']", override))
    assert result['step'] == 2 and np.isfinite(result['train_loss'])
    assert seen and set(seen) == {override.startswith('preserve_root')}
    # the last two keys left out, device_aug and device_aug_canvas, are ported
    # too (tests/test_torch_device_aug.py): the bin keeps no list of them
    assert not hasattr(train_3d, 'NOT_PORTED')


def _cudnn_flags():
    return torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic


def test_eval_and_infer_set_deterministic_cudnn_after_training(tmp_path, monkeypatch, capsys):
    """A train run leaves cuDNN's timed search on (deterministic=False);
    eval_3d.main and infer_single.main then turn it off, as
    margipose_tpu/bin/eval_3d.py and infer_single.py do. Eval runs on its
    default dataset, mpi3d-test."""
    before = _cudnn_flags()
    try:
        train_3d.main(_argv('margipose_model', "train_datasets=['mpi3d-train']",
                            "val_datasets=[]", 'train_examples=2'))
        assert _cudnn_flags() == (True, False)
        ckpt = str(tmp_path / 'model.pth')
        save_model(ckpt, create_model(small_desc(1)), small_desc(1))
        rows, _ = eval_3d.main(['--model', ckpt, '--batch-size', '2', '--device', 'cpu'])
        assert _cudnn_flags() == (False, True)
        assert 'TS1/Seq1' in capsys.readouterr().out and len(rows['mpjpe']) == 2

        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
        flags_at_load = []

        def load_model(*args, **kwargs):
            flags_at_load.append(_cudnn_flags())
            raise KeyboardInterrupt  # stop before the forward

        monkeypatch.setattr(infer_single, 'load_model', load_model)
        image = str(tmp_path / 'image.jpg')
        PIL.Image.new('RGB', (8, 8)).save(image)
        with pytest.raises(KeyboardInterrupt):
            infer_single.main(['--model', 'unused.pth', '--image', image, '--device', 'cpu'])
        assert flags_at_load == [(False, True)]
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = before
