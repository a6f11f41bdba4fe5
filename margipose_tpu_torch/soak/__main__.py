"""The soaks' command::

    python -m margipose_tpu_torch.soak corpus
    python -m margipose_tpu_torch.soak full-schedule [--dataset synthetic|fake] \\
        [--kill-at EPOCH] [--kill-in-save EPOCH] [--device cuda|cpu] [--out DIR] \\
        [-- KEY=VALUE...]
    python -m margipose_tpu_torch.soak chatterbox [the same options]
    python -m margipose_tpu_torch.soak verify EXP_DIR [--device cuda|cpu]

``corpus`` writes the fake corpus (``soak/corpus.py``) to ``$SOAK_DATA``
(default ``build/soak/data``). A recipe (``soak/recipes.py``) trains in a
child process, on the ``fake`` corpus (written first if missing) or on
``synthetic``; ``--kill-at k`` SIGKILLs it once ``model-latest`` says epoch
k and resumes, ``--kill-in-save j`` SIGKILLs a resumed run halfway through
epoch j's save and resumes again (``soak/run.py``); then the verifier
(``soak/verify.py``) runs in this process. ``KEY=VALUE`` words after ``--``
override the recipe's config (fewer epochs, a smaller model). The exit code
is the verifier's: non-zero on any FAIL.
"""

from __future__ import annotations

import argparse
import sys
from os import path

from margipose_tpu_torch.soak import corpus, run, verify
from margipose_tpu_torch.soak.recipes import DATASETS, RECIPES


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = []
    if '--' in argv:
        split = argv.index('--')
        argv, overrides = argv[:split], argv[split + 1:]
    parser = argparse.ArgumentParser(prog='python -m margipose_tpu_torch.soak',
                                     description='the soaks: long runs killed and resumed')
    parser.add_argument('command', choices=['corpus', *RECIPES, 'verify'])
    parser.add_argument('exp_dir', nargs='?', help='verify: the experiment directory')
    parser.add_argument('--dataset', choices=DATASETS, default='synthetic')
    parser.add_argument('--kill-at', type=int, metavar='EPOCH', default=None)
    parser.add_argument('--kill-in-save', type=int, metavar='EPOCH', default=None)
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; verify: the training run's)")
    parser.add_argument('--out', default=None,
                        help='output directory (default build/soak/<recipe>)')
    args = parser.parse_args(argv)
    if args.command == 'corpus':
        corpus.make_soak_corpus()
        return 0
    if args.command == 'verify':
        if args.exp_dir is None:
            parser.error('verify needs EXP_DIR')
        return verify.main(args.exp_dir, args.device)
    if args.dataset == 'fake':  # for the children and the verifier's eval
        corpus.use_fake_corpus()
    out = args.out or path.join(corpus.ROOT, 'build', 'soak', args.command)
    exp_dir = run.run_recipe(args.command, args.dataset, out, args.device or 'cuda',
                             kill_at=args.kill_at, kill_in_save=args.kill_in_save,
                             overrides=overrides)
    return verify.main(exp_dir)


if __name__ == '__main__':
    sys.exit(main())
