#!/usr/bin/env python3
"""3D pose inference on a single image, on the card.

Counterpart of ``margipose_tpu/bin/infer_single.py`` (reference:
src/margipose/bin/infer_single.py)::

    python -m margipose_tpu_torch.bin.infer_single --model FILE.pth \\
        --image resources/man_running.jpg [--multicrop] [--out-file OUT.png] \\
        [--device cpu]

The image is assumed to be centred on a human subject. It is area-reduced on
the host, then resized, colour-normalised and run through the model on the
device (``ops/image.device_augment``), in float32. The skeleton is printed
in normalised form and drawn to ``--out-file`` (PNG) when given or when no
display is available; otherwise a matplotlib window opens.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import PIL.Image
import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.cli import bin_subcommand
from margipose_tpu_torch.geometry.coords import ensure_cartesian
from margipose_tpu_torch.geometry.skeleton import CanonicalSkeletonDesc
from margipose_tpu_torch.models import data_specs_for_desc, default_data_specs
from margipose_tpu_torch.ops.image import device_augment
from margipose_tpu_torch.utils import init_algorithms, plot_skeleton_on_axes3d, seed_all


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog='margipose-torch-infer', description='3D human pose inference',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--model', type=str, metavar='FILE', required=True,
                        help='path to a reference-format .pth model file or a train-state '
                             'directory')
    parser.add_argument('--image', type=str, metavar='FILE', required=True,
                        help='image file to infer pose from')
    parser.add_argument('--out-file', type=str, metavar='FILE', default=None,
                        help='write the visualisation to this PNG instead of showing')
    parser.add_argument('--multicrop', action='store_true',
                        help='average predictions over 10 crops (2 flips x 5 offsets)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' runs on the host")
    return parser.parse_args(argv)


# The eval multicrop scheme (reference: src/margipose/data/mpi_inf_3dhp/
# __init__.py:332-360): 2 horizontal flips x 5 crop-centre offsets of 8 px.
_MULTICROP_FLIPS = (False, True)
_MULTICROP_OFFSETS = ((0, 0), (-8, 0), (0, -8), (8, 0), (0, 8))


def _multicrop_affines(base: np.ndarray, w: int) -> np.ndarray:
    """10 source->output affines: T(offset) then hflip about the output
    canvas, composed onto the base aspect-fit affine."""
    affines = []
    for flip in _MULTICROP_FLIPS:
        for dx, dy in _MULTICROP_OFFSETS:
            a = np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float32) @ base
            if flip:
                a = np.array([[-1, 0, w], [0, 1, 0], [0, 0, 1]], np.float32) @ a
            affines.append(a)
    return np.stack(affines).astype(np.float32)


def _merge_multicrop(preds: np.ndarray, w: int, h: int, hflip_indices) -> np.ndarray:
    """Back-map each crop's normalised prediction into the base frame and
    average: undo the flip first (negate x, swap left/right joints: the
    corner-convention hflip is exactly x -> -x in normalised coordinates),
    then the offset (2*d/size in normalised units)."""
    merged = []
    i = 0
    for flip in _MULTICROP_FLIPS:
        for dx, dy in _MULTICROP_OFFSETS:
            p = np.array(preds[i], np.float64)
            i += 1
            if flip:
                p = p[list(hflip_indices)]
                p[:, 0] = -p[:, 0]
            p[:, 0] -= 2.0 * dx / w
            p[:, 1] -= 2.0 * dy / h
            merged.append(p)
    return np.mean(merged, axis=0)


def prefilter(image: PIL.Image.Image, width: int, height: int):
    """The host half of fitting an image into (width, height), shared with
    ``bin/serve.letterbox_uint8`` so that infer and serve see the same
    pixels. Returns (uint8 HWC pixels, 3x3 aspect-fit affine).

    The warp that follows is single-tap bilinear, which aliases for scales
    under 0.5; so the image is area-averaged here first by the integer part
    of the binding fit ratio, and the affine's scale lies in (0.5, 1.0]."""
    image = image.convert('RGB')
    fit_scale = min(width / image.width, height / image.height, 1.0)
    reduce_factor = int(1.0 / fit_scale)
    if reduce_factor > 1:
        image = image.reduce(reduce_factor)
    src = np.asarray(image, np.uint8)
    scale = min(width / src.shape[1], height / src.shape[0], 1.0)
    return src, np.array([[scale, 0.0, 0.0], [0.0, scale, 0.0], [0.0, 0.0, 1.0]], np.float32)


def infer_image(model, image: PIL.Image.Image, model_desc=None, multicrop: bool = False,
                device='cuda'):
    """Resize + normalise (on ``device``) + forward, in float32.

    ``model`` is a module in eval mode on ``device``. Returns (input_array,
    coords [17, 3]): the normalised HWC model input (with ``multicrop``, the
    base crop) and the coordinates (with ``multicrop``, averaged over the 10
    crops, all forwarded as one batch)."""
    device = torch.device(device)
    specs = data_specs_for_desc(model_desc) if model_desc else default_data_specs()
    input_specs = specs.input_specs
    w, h = input_specs.width, input_specs.height

    pixels, base_affine = prefilter(image, w, h)
    src = pixels.astype(np.float32) / 255.0
    affines = _multicrop_affines(base_affine, w) if multicrop else base_affine[None]

    n = affines.shape[0]
    raw = torch.from_numpy(src).to(device)
    with torch.inference_mode():
        inp = device_augment(raw.expand(n, *raw.shape), torch.from_numpy(affines).to(device),
                             h, w, brightness=1.0, contrast=1.0, saturation=1.0, hue=0.0,
                             mean=input_specs.mean, std=input_specs.stddev)
        xyz, _ = model(inp.permute(0, 3, 1, 2).contiguous())
        preds = xyz.float().cpu().numpy()
        base_input = inp[0].cpu().numpy()
    if multicrop:
        output = _merge_multicrop(preds, w, h, CanonicalSkeletonDesc.hflip_indices)
    else:
        output = np.asarray(preds[0], np.float64)
    return base_input, output


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    seed_all(12345)
    init_algorithms(deterministic=True)
    device = resolve_device(args.device)
    set_float32_parity_mode()

    model, model_desc = load_model(args.model, device)
    image = PIL.Image.open(args.image, 'r')
    inp, output = infer_image(model, image, model_desc, multicrop=args.multicrop, device=device)

    norm_skel3d = ensure_cartesian(output, d=3)
    print('Normalized skeleton coordinates:')
    for name, xyz in zip(CanonicalSkeletonDesc.joint_names, norm_skel3d):
        print(f'  {name:16s} {xyz[0]:+.4f} {xyz[1]:+.4f} {xyz[2]:+.4f}')

    out_file = args.out_file
    if out_file is None and not os.environ.get('DISPLAY'):
        out_file = 'inference.png'

    import matplotlib

    if out_file:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(16, 8))
    ax1 = fig.add_subplot(1, 2, 1)
    ax2 = fig.add_subplot(1, 2, 2, projection='3d')
    ax1.imshow(data_specs_for_desc(model_desc).input_specs.unconvert(inp))
    plot_skeleton_on_axes3d(norm_skel3d, CanonicalSkeletonDesc, ax2, invert=True)
    if out_file:
        fig.savefig(out_file, dpi=100)
        plt.close(fig)
        print(f'wrote {out_file}')
    else:
        plt.show()
    return inp, output


Infer_Subcommand = bin_subcommand('infer', main, help='infer 3D pose for single image')


if __name__ == '__main__':
    main()
