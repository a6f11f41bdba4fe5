"""The port's on-device augmentation against the JAX package's, on the CPU.

Mirrors ``tests/test_device_aug.py``. With ``device_aug`` set, a dataset
ships the raw uint8 frame, the composed 3x3 affine and the four colour
parameters in place of a host-warped ``input``; the train bin uploads them
and warps, jitters and normalises the batch on the device
(``ops/image.device_augment``). Both packages read one fake corpus
(MPI-INF-3DHP frames at 768 px, Human3.6M at 1000 px, MPII at 512 px) with
the same specs and seeds, so the shipped fields must be equal bit for bit
in every mode: a frame that matches the canvas passes through, a smaller
one is zero-padded, a larger one downscaled (PIL, in both), and crop-ship
cuts the affine's source region and letterboxes it onto a small canvas.
The port's aug step holds JAX's within 1e-5 in pixel units ([0, 1]), as
``tests/test_torch_image_ops.py`` holds ``device_augment``, but for a few
elements of 768 px frames, where float32 cannot place a sample coordinate
closer than 6.1e-5 px (``test_aug_step_matches_jax``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import margipose_tpu.data.get_dataset as jax_get_dataset
import margipose_tpu.train.helpers as jax_helpers
import margipose_tpu_torch.bin.train_3d as train_3d
import margipose_tpu_torch.data.get_dataset as get_dataset
import margipose_tpu_torch.train.helpers as helpers
from margipose_tpu.data import fake_mpi3d as jax_fake_mpi3d
from margipose_tpu.data import fakes as jax_fakes
from margipose_tpu.models import data_specs_for_desc as jax_specs_for_desc
from margipose_tpu.ops.image import device_augment as jax_device_augment
from margipose_tpu_torch.data.loader import DEVICE_FIELDS
from margipose_tpu_torch.models import data_specs_for_desc

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESC = {'settings': {'input_size': 64}}
AUG_FIELDS = ('raw_image', 'aug_affine', 'aug_colour')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('datasets'))
    gen = jax_fake_mpi3d.generate_fake_mpi3d
    gen(os.path.join(base, 'mpi3d', 'train'), seqs=((2, 2),), camera_ids=(0,), n_frames=2)
    gen(os.path.join(base, 'mpi3d', 'val'), seqs=((1, 1),), camera_ids=(0,), n_frames=2, seed=1)
    jax_fakes.generate_fake_h36m(os.path.join(base, 'h36m'), subjects=(1,), camera_ids=(1,),
                                 n_frames=2)
    jax_fakes.generate_fake_mpii(os.path.join(base, 'mpii'), n_train=2, n_val=2)
    return base


@pytest.fixture(autouse=True)
def _environment(corpus, monkeypatch):
    monkeypatch.setenv('MARGIPOSE_BASE_DATA_DIR', corpus)
    monkeypatch.setenv('MARGIPOSE_RESOURCES_DIR', os.path.join(ROOT, 'resources'))


# (dataset, canvas: None for the source's raw_size, crop-ship?, what it covers)
CASES = {
    'synthetic-full': ('synthetic-4', None, False),     # 512 px pass-through
    'synthetic-crop': ('synthetic-4', 384, True),       # crop fits: pad only
    'synthetic-crop-downscale': ('synthetic-4', 48, True),
    'mpi3d-full': ('mpi3d-train', None, False),         # 768 px pass-through
    'h36m-full-downscale': ('h36m-trainval', 768, False),  # 1000 px onto 768
    'mpii-full-pad': ('mpii-train', 768, False),         # 512 px onto 768
    'mpii-crop': ('mpii-train', 128, True),
}


def _device_aug(dataset, canvas, crop):
    dataset.device_aug = True
    dataset.device_aug_canvas = None if canvas is None else (canvas, canvas)
    dataset.device_aug_crop = crop
    return dataset


@pytest.mark.parametrize('case', sorted(CASES))
def test_sample_fields_equal_jax(case):
    name, canvas, crop = CASES[case]
    theirs = _device_aug(jax_get_dataset.get_dataset(
        name, jax_specs_for_desc(DESC), use_aug=True, seed=5), canvas, crop)
    ours = _device_aug(get_dataset.get_dataset(
        name, data_specs_for_desc(DESC), use_aug=True, seed=5), canvas, crop)
    side = canvas or ours.raw_size[0]
    for i in range(2):
        want, got = theirs[i], ours[i]
        assert 'input' not in got and set(got) == set(want)
        assert got['raw_image'].shape == (side, side, 3) and got['raw_image'].dtype == np.uint8
        assert got['aug_affine'].shape == (3, 3) and got['aug_colour'].shape == (4,)
        for key in AUG_FIELDS + ('target', 'joint_mask'):
            assert_array_equal(got[key], want[key], err_msg=key)


def _mixed_loaders(canvas):
    names = ['mpi3d-trainval', 'mpii-trainval']
    kwargs = dict(batch_size=4, examples_per_epoch=4, use_aug=True, num_workers=0, seed=0,
                  device_aug=True, device_aug_canvas=canvas)
    return (jax_helpers.create_train_dataloader(names, jax_specs_for_desc(DESC), **kwargs),
            helpers.create_train_dataloader(names, data_specs_for_desc(DESC), **kwargs))


@pytest.mark.parametrize('canvas', [0, 128], ids=['full', 'crop'])
def test_mixed_loader_batch_equals_jax(canvas):
    """The flagship recipe's loader (mpi3d-trainval + mpii-trainval) ships
    one raw canvas for both sources: 768 px full frames (mpi3d's fixed
    size), or the crops on 128 px."""
    theirs, ours = _mixed_loaders(canvas)
    want, got = next(iter(theirs)), next(iter(ours))
    side = canvas or 768
    assert 'input' not in got and got['raw_image'].shape == (4, side, side, 3)
    assert set(np.asarray(got['valid_depth']).tolist()) == {0, 1}
    for key in DEVICE_FIELDS[1:]:
        assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize('canvas', [0, 128], ids=['full', 'crop'])
def test_aug_step_matches_jax(canvas):
    """The train bin's aug step against the JAX bin's on the same mixed
    batch: raw uint8 -> /255 -> device_augment -> normalised input."""
    _, ours = _mixed_loaders(canvas)
    batch = next(iter(ours))
    specs = ours.dataset.data_specs.input_specs
    colour = jnp.asarray(batch['aug_colour'])
    expected = jax_device_augment(
        jnp.asarray(batch['raw_image']).astype(jnp.float32) / 255.0,
        jnp.asarray(batch['aug_affine']), specs.height, specs.width,
        colour[:, 0], colour[:, 1], colour[:, 2], colour[:, 3],
        tuple(specs.mean), tuple(specs.stddev))
    got = train_3d.make_aug_step(specs)(*(torch.from_numpy(np.asarray(batch[k]))
                                          for k in AUG_FIELDS))
    side = batch['raw_image'].shape[1]
    assert got.shape == (4, 3, 64, 64) and got.dtype == torch.float32
    std = np.asarray(specs.stddev, np.float32)
    err = np.abs(got.permute(0, 2, 3, 1).numpy() * std - np.asarray(expected) * std)
    # 1e-5 everywhere on the crop canvas (2.1e-6 measured). On 768 px
    # frames the float32 geometry itself differs: JAX's float32 inverse
    # affine is one ulp of a 768 px coordinate (6.1e-5 px) off the float64
    # inverse the port rounds to float32, and a sample on a full-scale edge
    # moves with its coordinate: 2.29e-5 at most, on 0.21% of the elements
    # (CPU, this batch)
    atol = 1e-5 if canvas else 1e-5 + np.spacing(np.float32(side))
    assert err.max() <= atol, err.max()
    assert np.mean(err > 1e-5) <= 0.005, np.mean(err > 1e-5)


@pytest.mark.parametrize('words', [
    ("train_datasets=['synthetic-16']", 'device_aug=True'),
    ("train_datasets=['synthetic-16']", 'device_aug=True', 'device_aug_canvas=64'),
    ("train_datasets=['mpi3d-trainval', 'mpii-trainval']", 'device_aug=True'),
], ids=['full', 'crop', 'mixed_2d_3d'])
def test_train_bin_augments_on_the_device(words, tmp_path, monkeypatch):
    """The bin uploads raw uint8 frames and augments each batch once through
    ops/image.device_augment; the steps' losses are finite and the
    checkpoint is written. The 'full' run keeps an output directory, so its
    example grid is drawn from the device-augmented input."""
    shipped = []
    real_augment = train_3d.device_augment

    def counting(images, affines, *args):
        shipped.append((images.shape, affines.shape))
        return real_augment(images, affines, *args)

    monkeypatch.setattr(train_3d, 'device_augment', counting)
    out = str(tmp_path) if words[-1] == 'device_aug=True' and 'synthetic' in words[0] else ''
    result = train_3d.main([
        '--device', 'cpu', 'with', 'margipose_model', "val_datasets=['synthetic-2@1']",
        "model_desc={'settings': {'n_stages': 1, 'input_size': 64}}", *words,
        'epochs=1', 'batch_size=2', 'train_examples=4', 'val_examples=2', 'num_workers=0',
        'metrics_every=1', f'out_dir={out}', 'experiment_id=aug'])
    assert result['step'] == 2 and np.isfinite(result['train_loss'])
    side = 64 if 'device_aug_canvas=64' in words else (512 if 'synthetic' in words[0] else 768)
    assert shipped == [((2, side, side, 3), (2, 3, 3))] * 2
    if out:
        assert os.path.isfile(os.path.join(out, 'aug', 'train_examples.png'))
        assert os.path.isdir(os.path.join(out, 'aug', 'model-latest', 'state'))
