#!/usr/bin/env python3
"""Export a trained model for sharing.

Counterpart of ``margipose_tpu/bin/export_model.py`` (reference:
src/margipose/bin/export_model.py). The input is a reference-format ``.pth``
or a train-state directory of the port (``checkpoint.load_model``).
Formats:
  * ``native``: a weights-only train-state directory
    (``train/checkpoint.save_weights``: no optimiser state), which
    ``checkpoint.load_model`` reads back;
  * ``torch``: a reference-format ``.pth``, ``{state_dict, model_desc,
    train_datasets, epoch}``, which the JAX package's and the original
    implementation's loaders read with ``strict=True``;
  * ``export``: ``torch.export`` of the eval forward, images ``[1, 3, H,
    W]`` float32 to coordinates ``[1, J, 3]``, on ``--device``, written with
    ``torch.export.save`` (the counterpart of the JAX package's serialised
    StableHLO; no ONNX)::

    python -m margipose_tpu_torch.bin.export_model -i MODEL -o OUT [-f native|torch|export]
"""

from __future__ import annotations

import argparse
import sys

import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.utils import init_algorithms, seed_all


def parse_args(argv):
    """``argv[0]`` is the program's name, as in the JAX bin."""
    parser = argparse.ArgumentParser(prog='margipose-torch-export-model',
                                     description='3D pose estimation model exporter')
    parser.add_argument('-i', '--input', type=str, metavar='FILE', required=True,
                        help='path to input model (.pth or train-state directory)')
    parser.add_argument('-o', '--output', type=str, metavar='PATH', required=True,
                        help='desired output path')
    parser.add_argument('-f', '--format', type=str, default='native',
                        choices=['native', 'torch', 'export'],
                        help='format of output model')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device the exported program is traced on ('export')")
    return parser.parse_args(argv[1:])


class _Coordinates(torch.nn.Module):
    """The eval forward's coordinates alone."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images):
        return self.model(images)[0]


def export_program(model, model_desc, output, device):
    """``torch.export`` of the eval forward at batch 1, saved to ``output``."""
    from margipose_tpu_torch.models import data_specs_for_desc

    specs = data_specs_for_desc(model_desc).input_specs
    dummy = torch.zeros(1, 3, specs.height, specs.width, device=device)
    exported = torch.export.export(_Coordinates(model).eval(), (dummy,))
    torch.export.save(exported, output)
    print(f'wrote torch.export program to {output} ({tuple(dummy.shape)} -> '
          f'{tuple(exported.module()(dummy).shape)})')


def main(argv=None):
    args = parse_args(sys.argv if argv is None else argv)
    seed_all(12345)
    init_algorithms(deterministic=True)
    device = resolve_device(args.device)

    from margipose_tpu_torch.checkpoint import load_model
    from margipose_tpu_torch.train.checkpoint import save_weights

    model, model_desc = load_model(args.input, device)

    if args.format == 'native':
        save_weights(args.output, model, model_desc)
        print(f'wrote weights-only checkpoint to {args.output}')
    elif args.format == 'export':
        export_program(model, model_desc, args.output, device)
    elif args.format == 'torch':
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({'state_dict': sd, 'model_desc': model_desc,
                    'train_datasets': [], 'epoch': 0}, args.output)
        print(f'wrote reference-format torch checkpoint to {args.output}')


if __name__ == '__main__':
    main()
