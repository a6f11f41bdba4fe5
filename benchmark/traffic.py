"""The one generator of traffic: a cell's ``traffic`` parameters and the
seed in, host batches and arrival times out. The same seed gives the same
inputs; every seed gives the same sizes and the same set of gaps between
arrivals, in another order.

Batches (``batches``): ``pool`` batches of ``batch`` uint8 RGB frames of
``frame`` = [H, W] pixels, drawn uniformly, with targets uniform within
+-``target_range`` in normalised coordinates (x, y, z), every joint in the
mask, and every row 3D (``valid_depth`` 1). The window takes them in turn.

Arrivals (``arrivals``): an open loop at ``rate`` requests a second. The
gaps are the quantiles (i + 1/2) / n of the exponential distribution, so a
Poisson process's gaps, shuffled by the seed; request i asks for frame
``frames[i]`` of a pool of ``pool`` frames drawn as above.
"""

import numpy as np


def _rng(seed, stream):
    return np.random.default_rng([stream, seed])


def frames(shape, seed, stream):
    return _rng(seed, stream).integers(0, 256, shape, dtype=np.uint8)


def batches(traffic, n_joints, seed):
    """``traffic['pool']`` host batches: dicts of numpy arrays 'pixels'
    [B, H, W, 3] uint8, 'target' [B, J, 3], 'joint_mask' [B, J] and
    'valid_depth' [B]."""
    b, (h, w), n = traffic['batch'], traffic['frame'], traffic['pool']
    pixels = frames((n, b, h, w, 3), seed, 0)
    r = traffic['target_range']
    target = _rng(seed, 1).uniform(-r, r, (n, b, n_joints, 3)).astype(np.float32)
    return [{'pixels': pixels[i], 'target': target[i],
             'joint_mask': np.ones((b, n_joints), np.float32),
             'valid_depth': np.ones(b, np.int32)} for i in range(n)]


def normalised(pixels):
    """The host's model input of uint8 ``pixels``: ImageNet-normalised NHWC
    float32, as a data loader hands it to a float32 upload."""
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    return (pixels.astype(np.float32) / 255.0 - mean) / std


def shard(pool, shards, index):
    """Block ``index`` of ``shards`` equal contiguous row blocks of every
    batch, as a data-parallel group's processes hold them."""
    per = len(pool[0]['pixels']) // shards
    return [{k: v[index * per:(index + 1) * per] for k, v in batch.items()} for batch in pool]


def arrivals(rate, seconds, n_frames, seed):
    """(due times in seconds from the window's start, the first at 0, and the
    frame of each): round(rate * seconds) requests."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = _rng(seed, 2)
    due = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps)[:-1])])
    return due, rng.integers(0, n_frames, n)
