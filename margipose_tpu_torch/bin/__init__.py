"""The ``margipose`` command of the port (counterpart of
``margipose_tpu/bin/__init__.py``; reference: src/margipose/bin/__init__.py:14-33)::

    python -m margipose_tpu_torch.bin [--device cuda|cpu] SUBCOMMAND ...
"""

from __future__ import annotations

import sys

from margipose_tpu_torch.cli import create_common_arg_parser


def _subcommands():
    # Imported lazily so `margipose train --help` doesn't pay for GUI deps etc.
    from margipose_tpu_torch.bin.eval_3d import Eval_Subcommand
    from margipose_tpu_torch.bin.hyperparam_search import Hyperparams_Subcommand
    from margipose_tpu_torch.bin.infer_single import Infer_Subcommand
    from margipose_tpu_torch.bin.run_gui import GUI_Subcommand
    from margipose_tpu_torch.bin.serve import Serve_Subcommand
    from margipose_tpu_torch.bin.train_3d import Train_Subcommand

    subs = [
        GUI_Subcommand,
        Eval_Subcommand,
        Train_Subcommand,
        Hyperparams_Subcommand,
        Infer_Subcommand,
        Serve_Subcommand,
    ]
    return {s.name: s for s in subs}


def main(argv=None):
    if argv is None:
        argv = sys.argv
    subcommands = _subcommands()
    parser = create_common_arg_parser()
    subparsers = parser.add_subparsers(dest='subparser_name', title='subcommands')
    for subcmd in subcommands.values():
        subparsers.add_parser(subcmd.name, add_help=False, help=subcmd.help)

    args, subargs = parser.parse_known_args(argv[1:])
    if args.subparser_name is not None:
        # the subcommand's result is not returned: a console script exits
        # with main's return value
        subcommands[args.subparser_name].run([argv[0]] + subargs, args)
    else:
        parser.print_usage()


if __name__ == '__main__':
    main()
