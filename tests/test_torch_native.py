"""The port's host-ops library against the JAX package's, on the CPU.

``margipose_tpu_torch.native`` binds the port's own copy of the JAX
package's native host ops (``csrc/host_ops.cpp``), built by g++ with the
JAX flags into ``build/margipose_tpu_torch/``. Both libraries must give the
same bits: the warp, the fused warp + colour jitter (with and without
normalisation) and the composite, over random images, affines and jitters,
and so the augmented examples of ``TransformerContext``.
``MARGIPOSE_DISABLE_NATIVE`` puts both packages on PIL, where they agree
too. Where the JAX package falls back to PIL when its build fails, the
port raises.
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch

import margipose_tpu.native as jax_native
from margipose_tpu.geometry.camera import CameraIntrinsics as JaxCamera
from margipose_tpu.geometry.transforms import TransformerContext as JaxContext
from margipose_tpu_torch import native
from margipose_tpu_torch.geometry.camera import CameraIntrinsics
from margipose_tpu_torch.geometry.transforms import (
    TransformerContext,
    adjust_colour_pil,
    build_affine,
    warp_image_pil,
)
from margipose_tpu_torch.ops import _build

# one intra-op thread a process: the suite runs six workers on an eight-core box
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(autouse=True)
def both_native():
    assert native.available() and jax_native.available()


def _case(seed):
    """A random image (smooth or noise), an output<-input affine that may
    reach past the source's edges, and an output size."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(24, 90, 2)
    img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    if seed % 2:
        img = np.array(PIL.Image.fromarray(img[::4, ::4]).resize((w, h), PIL.Image.BILINEAR))
    affine = build_affine(dict(
        centre_x=rng.uniform(0, w), centre_y=rng.uniform(0, h), rotation=rng.uniform(-40, 40),
        scale=rng.uniform(0.4, 1.3), hflip=bool(rng.rand() < 0.5), in_width=w, in_height=h,
        out_width=int(rng.randint(16, 48)), out_height=int(rng.randint(16, 48))))
    return rng, img, affine, (int(rng.randint(16, 48)), int(rng.randint(16, 48)))


def _jitter(rng):
    return dict(brightness=rng.uniform(0.7, 1.3), contrast=rng.uniform(0.7, 1.3),
                saturation=rng.uniform(0.6, 1.4), hue=rng.choice([0.0, rng.uniform(-0.1, 0.1)]))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize('seed', range(6))
def test_warp_rgb_equals_jax_bit_for_bit(seed):
    _, img, affine, out_size = _case(seed)
    got = native.warp_rgb(img, affine, out_size)
    assert got.shape == out_size[::-1] + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_native.warp_rgb(img, affine, out_size))


@pytest.mark.parametrize('normalise', [False, True], ids=['unnormalised', 'normalised'])
@pytest.mark.parametrize('seed', range(4))
def test_warp_colour_norm_equals_jax_bit_for_bit(seed, normalise):
    rng, img, affine, out_size = _case(100 + seed)
    kwargs = dict(_jitter(rng), **(dict(mean=MEAN, std=STD) if normalise else {}))
    got = native.warp_colour_norm(img, affine, out_size, **kwargs)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax_native.warp_colour_norm(img, affine, out_size,
                                                                    **kwargs)))


def test_composite_equals_jax_bit_for_bit():
    rng = np.random.RandomState(7)
    fg, bg = (rng.randint(0, 256, (37, 53, 3), dtype=np.uint8) for _ in range(2))
    mask = rng.randint(0, 256, (37, 53), dtype=np.uint8)
    got = native.composite(fg, bg, mask)
    np.testing.assert_array_equal(got, jax_native.composite(fg, bg, mask))
    ref = np.asarray(PIL.Image.composite(PIL.Image.fromarray(fg), PIL.Image.fromarray(bg),
                                         PIL.Image.fromarray(mask, 'L')))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        native.composite(fg, bg[:-1], mask)


def _augment(seed, as_array):
    """The port's and the JAX package's TransformerContext on one augmented
    example: (port image, JAX image) as uint8 arrays."""
    rng, img, _, _ = _case(200 + seed)
    h, w = img.shape[:2]
    opts = dict(centre_x=rng.uniform(0, w), centre_y=rng.uniform(0, h),
                rotation=rng.uniform(-30, 30), scale=rng.uniform(0.5, 1.2),
                hflip=bool(seed % 2), in_width=w, in_height=h, out_width=32, out_height=32,
                hflip_indices=list(range(17)), **_jitter(rng))
    image = img if as_array else PIL.Image.fromarray(img)
    points = np.zeros((17, 4))
    _, ours, _ = TransformerContext(opts).transform(
        CameraIntrinsics.from_ccd_params(50.0, 50.0, w / 2, h / 2), image, points)
    _, theirs, _ = JaxContext(opts).transform(
        JaxCamera.from_ccd_params(50.0, 50.0, w / 2, h / 2), image, points)
    return np.asarray(ours), np.asarray(theirs)


@pytest.mark.parametrize('as_array', [False, True], ids=['pil', 'array'])
@pytest.mark.parametrize('seed', range(3))
def test_augmented_example_equals_jax_bit_for_bit(seed, as_array):
    ours, theirs = _augment(seed, as_array)
    assert ours.shape == (32, 32, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


@pytest.fixture
def native_disabled(monkeypatch):
    """MARGIPOSE_DISABLE_NATIVE in both packages (the JAX one reads it once,
    at its first load, so its cached decision is reset)."""
    monkeypatch.setenv('MARGIPOSE_DISABLE_NATIVE', '1')
    monkeypatch.setattr(jax_native, '_lib', None)
    monkeypatch.setattr(jax_native, '_tried', False)
    assert not native.available() and not jax_native.available()


@pytest.mark.parametrize('seed', range(2))
def test_disable_native_puts_both_on_pil(native_disabled, seed):
    ours, theirs = _augment(seed, as_array=False)
    np.testing.assert_array_equal(ours, theirs)
    rng, img, _, _ = _case(200 + seed)
    with pytest.raises(RuntimeError, match='MARGIPOSE_DISABLE_NATIVE'):
        native.warp_rgb(img, np.eye(3), (8, 8))


def test_pil_and_native_differ_by_a_few_lsbs():
    """Why the port needs the library: PIL rounds to uint8 after the warp and
    after each colour pass, the library once at the end."""
    rng, img, affine, out_size = _case(300)
    jitter = _jitter(rng)
    fused = native.warp_colour_norm(img, affine, out_size, **jitter)
    fused = (fused * 255 + 0.5).astype(np.uint8).astype(int)
    pil = np.asarray(adjust_colour_pil(warp_image_pil(PIL.Image.fromarray(img), affine, out_size),
                                       **jitter)).astype(int)
    assert np.abs(fused - pil).mean() < 3.0


def test_library_is_the_ports_own_copy():
    """Built from csrc/, never from native/ (the JAX package's), with the JAX
    flags, into build/margipose_tpu_torch keyed by a hash of the source and
    the toolchain; the code is the JAX library's, line for line, below its
    header comment."""
    src, flags = _build._source(native.LIBRARY)
    assert src == os.path.join(ROOT, 'margipose_tpu_torch', 'csrc', 'host_ops.cpp')
    assert flags == ['-O3', '-fPIC', '-shared', '-std=c++17']
    lib = _build.library_path(native.LIBRARY)
    assert os.path.dirname(lib) == os.path.join(ROOT, 'build', 'margipose_tpu_torch')
    assert re.fullmatch(r'libhost_ops-[0-9a-f]{16}\.so', os.path.basename(lib))
    assert os.path.isfile(lib) and native._lib._name == lib

    def code(path):
        text = open(path).read()
        return text[text.index('#include'):]

    assert code(src) == code(os.path.join(ROOT, 'native', 'margipose_host_ops.cpp'))


def test_a_library_from_another_host_or_compiler_is_not_loaded(monkeypatch):
    """A build/ copied from another machine along with the checkout is never
    loaded: the library's name changes with the host and the compiler."""
    here = _build.library_path(native.LIBRARY)
    monkeypatch.setattr(_build, '_toolchain', functools.lru_cache(_build._toolchain.__wrapped__))
    monkeypatch.setattr(_build.platform, 'node', lambda: 'another-host')
    other_host = _build.library_path(native.LIBRARY)
    monkeypatch.setattr(_build, '_toolchain', lambda compiler: 'g++ (another) 99.0')
    other_compiler = _build.library_path(native.LIBRARY)
    assert len({here, other_host, other_compiler}) == 3


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """Nothing built or loaded yet, with the build going to ``tmp_path``."""
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_libs', {})
    monkeypatch.setattr(native, '_lib', None)
    return tmp_path


def test_a_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match=r'g\+\+ not found'):
        native.available()


def test_a_failed_build_raises(fresh_build, monkeypatch):
    csrc = fresh_build / 'csrc'
    csrc.mkdir()
    (csrc / 'host_ops.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(_build, 'CSRC', str(csrc))
    with pytest.raises(RuntimeError, match='host_ops.cpp failed to build'):
        native.warp_rgb(np.zeros((4, 4, 3), np.uint8), np.eye(3), (4, 4))
    assert not os.listdir(fresh_build / 'build')  # no half-written library left


def test_processes_racing_on_one_build_all_load_it(tmp_path):
    """Loader workers may build at once: each writes its own temp file and
    renames a whole library into place."""
    code = ('import sys\n'
            'from margipose_tpu_torch.ops import _build\n'
            'from margipose_tpu_torch import native\n'
            '_build.BUILD_DIR = sys.argv[1]\n'
            'out = native.warp_rgb(__import__("numpy").full((4, 4, 3), 9, "uint8"),\n'
            '                      __import__("numpy").eye(3), (4, 4))\n'
            'assert (out == 9).all()\n')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(tmp_path)], cwd=ROOT,
                              env={**os.environ, 'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'},
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert [f for f in os.listdir(tmp_path)] == [os.path.basename(_build.library_path('host_ops'))]
