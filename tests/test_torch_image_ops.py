"""The port's device image ops against ``margipose_tpu.ops.image`` and
``margipose_tpu.data.specs.device_renormalize``.

The same seeded numpy inputs go through both packages on the CPU; every
output must agree to atol 1e-5 in pixel units ([0, 1]). The remaining
differences are float32 rounding: the affine inverse (an LU solve in both,
rounded apart by an ulp) moves the sample points of random-noise images, and
sums are taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import margipose_tpu.ops.image as jax_image
from margipose_tpu.data.specs import device_renormalize as jax_device_renormalize
from margipose_tpu_torch.data.specs import ImageSpecs, device_renormalize
from margipose_tpu_torch.data.synthetic import SyntheticPoseDataset
from margipose_tpu_torch.ops import image

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ATOL = 1e-5
MEAN, STD = ImageSpecs.IMAGENET_MEAN, ImageSpecs.IMAGENET_STDDEV


def _affine(scale, degrees, tx, ty):
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    return np.array([[scale * c, -scale * s, tx], [scale * s, scale * c, ty], [0, 0, 1]],
                    np.float32)


def _images(seed, b=3, h=20, w=30):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def _close(got: torch.Tensor, expected):
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL)


@pytest.mark.parametrize('case', ['shrink', 'enlarge', 'rotation', 'source_edges', 'rows_2x3'])
def test_affine_warp_matches_jax(case):
    imgs = _images(0)
    affines = {
        'shrink': [_affine(0.5, 0, 1.0, -2.0), _affine(0.3, 0, 0, 0), _affine(0.75, 0, 3, 1)],
        'enlarge': [_affine(2.3, 0, -5, 3), _affine(4.0, 0, 0, 0), _affine(1.7, 0, -20, -9)],
        'rotation': [_affine(1.0, 30, 10, -4), _affine(0.8, -65, 12, 20), _affine(1.4, 180, 40, 30)],
        # samples past every edge: zero fill, and floor (not truncation) on
        # negative source coordinates
        'source_edges': [_affine(1.0, 0, 7.3, 5.6), _affine(1.0, 0, -12.5, -8.25),
                         _affine(0.6, 10, 25, -3)],
        'rows_2x3': [_affine(0.9, 15, 2, 2), _affine(1.1, -5, -1, 3), _affine(1.0, 0, 0.5, 0.5)],
    }[case]
    a = np.stack(affines)
    if case == 'rows_2x3':
        a = a[:, :2]
    expected = jax_image.affine_warp(jnp.asarray(imgs), jnp.asarray(a), 24, 36)
    got = image.affine_warp(torch.from_numpy(imgs), torch.from_numpy(a), 24, 36)
    assert got.shape == (3, 24, 36, 3)
    _close(got, expected)
    if case == 'source_edges':
        assert (got.numpy() == 0).any() and (got.numpy() > 0).any()


def test_adjust_colour_with_hue_matches_jax():
    imgs = _images(1)
    factors = [np.array(v, np.float32) for v in
               ([0.8, 1.3, 1.0], [1.1, 0.9, 1.0], [0.7, 1.3, 1.0], [0.1, -0.08, 0.0])]
    expected = jax_image.adjust_colour(jnp.asarray(imgs), *factors)
    got = image.adjust_colour(torch.from_numpy(imgs), *(torch.from_numpy(f) for f in factors))
    _close(got, expected)
    # scalars broadcast over the batch, as in the JAX function
    _close(image.adjust_colour(torch.from_numpy(imgs), 1.1, 0.9, 1.2, 0.05),
           jax_image.adjust_colour(jnp.asarray(imgs), 1.1, 0.9, 1.2, 0.05))


def test_hsv_round_trip_matches_jax():
    rgb = _images(2)
    rgb[0, :4] = 0.5  # grey: zero span
    rgb[1, :2] = 0.0  # black: zero max
    hsv = image.rgb_to_hsv(torch.from_numpy(rgb))
    _close(hsv, jax_image.rgb_to_hsv(jnp.asarray(rgb)))
    _close(image.hsv_to_rgb(hsv), jax_image.hsv_to_rgb(jnp.asarray(hsv.numpy())))
    _close(image.hsv_to_rgb(hsv), rgb)


def test_normalize_imagenet_matches_jax():
    imgs = _images(3)
    _close(image.normalize_imagenet(torch.from_numpy(imgs), MEAN, STD),
           jax_image.normalize_imagenet(jnp.asarray(imgs), MEAN, STD))


def test_device_augment_matches_jax():
    imgs = _images(4, b=2, h=48, w=40)
    a = np.stack([_affine(0.9, 20, 4, -3), _affine(1.3, -10, -6, 2)])
    colour = [np.array(v, np.float32) for v in ([1.1, 0.9], [0.95, 1.2], [1.0, 0.8], [0.0, 0.07])]
    expected = jax_image.device_augment(jnp.asarray(imgs), jnp.asarray(a), 32, 32, *colour,
                                        MEAN, STD)
    got = image.device_augment(torch.from_numpy(imgs), torch.from_numpy(a), 32, 32,
                               *(torch.from_numpy(c) for c in colour), MEAN, STD)
    # held in pixel units, [0, 1], as the other ops: the normalisation divides
    # the warp's rounding (up to about 7e-6 here) by std, about 0.225
    std = np.asarray(STD, np.float32)
    _close(got * torch.from_numpy(std), np.asarray(expected) * std)


def test_device_renormalize_matches_jax_and_inverts_requantize():
    ds = SyntheticPoseDataset(length=2, use_aug=False)
    specs = ds.data_specs.input_specs
    inputs = np.stack([ds[i]['input'] for i in range(2)])
    u8 = specs.requantize(inputs)
    assert u8.dtype == np.uint8
    got = device_renormalize(torch.from_numpy(u8), specs)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 256, 256)
    expected = np.asarray(jax_device_renormalize(jnp.asarray(u8), specs)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), expected)
    # lossless: the host-normalised float32 input comes back to the last ulp
    np.testing.assert_allclose(got.numpy(), inputs.transpose(0, 3, 1, 2), rtol=0, atol=3e-6)
    # no specs: identity normalisation
    np.testing.assert_array_equal(device_renormalize(torch.from_numpy(u8), None).numpy(),
                                  u8.transpose(0, 3, 1, 2) / np.float32(255.0))
