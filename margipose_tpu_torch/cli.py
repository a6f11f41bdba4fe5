"""Root CLI plumbing of the ``margipose`` command.

Counterpart of ``margipose_tpu/cli.py`` (reference: src/margipose/cli.py:7-38).
The global ``--device`` takes a torch device string and defaults to
``cuda``. It is resolved through ``margipose_tpu_torch.resolve_device``, so
asking for CUDA where there is no card raises: the JAX package's ``cuda ->
cpu`` fall-back would hide which device ran.
"""

from __future__ import annotations

import argparse
import sys

import torch

from margipose_tpu_torch import resolve_device


def create_common_arg_parser():
    parser = argparse.ArgumentParser(
        prog='margipose', formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        '--device', default='cuda',
        help="torch device the subcommand runs on: 'cuda', 'cuda:N' or 'cpu'")
    return parser


def apply_device_option(device: str) -> torch.device:
    """The device a subcommand runs on; raises for CUDA without a card."""
    return resolve_device(device)


def common_args_to_opts(common_args):
    return dict(device=common_args.device)


def _own_device(argv, default):
    """The subcommand's own ``--device`` where its arguments give one (the
    bin parses it the same way and takes the last), else ``default``."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument('--device', default=default)
    return parser.parse_known_args(argv)[0].device


class Subcommand:
    def __init__(self, name, func, help=None):
        self.name = name
        self.func = func
        self.help = help

    def run(self, argv=None, common_args=None):
        """``func(argv, opts)``: ``argv[0]`` is the program's name, and
        ``opts['device']`` the device the subcommand runs on, resolved
        first."""
        if argv is None:
            argv = sys.argv
        if common_args is None:
            common_args = create_common_arg_parser().parse_args([])
        opts = common_args_to_opts(common_args)
        opts['device'] = _own_device(argv[1:], opts['device'])
        apply_device_option(opts['device'])
        return self.func(argv, opts)


def bin_subcommand(name, main, help=None):
    """A ``Subcommand`` over a bin's ``main(argv)``, whose own ``--device``
    defaults to the one ``run`` resolved: the bin's other flags and its
    ``main`` stay as they are."""
    def func(argv, common_opts):
        return main(['--device', common_opts['device'], *argv[1:]])

    return Subcommand(name, func, help)
