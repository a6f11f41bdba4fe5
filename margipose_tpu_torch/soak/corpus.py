"""The soaks' shared miniature corpus: fake MPI-INF-3DHP and MPII.

Port of ``scripts/make_soak_corpus.py``, through the port's own
``data/fake_mpi3d.py`` and ``data/fakes.py``: one recipe for every soak, so
that two soaks never meet a corpus the other one wrote differently. The
corpus is HDF5, so it needs ``h5py``; the soaks' ``synthetic`` variants need
no corpus.

The corpus counts as made only once its last part is on disk: a hidden
``.complete`` file (so that the corpus's files stay the script's), written
after every generator has returned. A generation that stopped part-way
(killed, or a generator that raised) leaves no such file, and the next call
removes what it left and generates it all again. (The JAX package's script
tests only ``mpi3d/train``, so a corpus cut off after its first part passes
there for whole.)
"""

from __future__ import annotations

import os
import shutil
from os import path

from margipose_tpu_torch.data.fake_mpi3d import generate_fake_mpi3d
from margipose_tpu_torch.data.fakes import generate_fake_mpii

ROOT = path.dirname(path.dirname(path.dirname(path.abspath(__file__))))
PARTS = ('mpi3d', 'mpii')  # every directory the corpus writes under its base
SENTINEL = '.complete'     # written last: the corpus is whole


def default_dir() -> str:
    """``$SOAK_DATA``, else ``build/soak/data`` at the root of the checkout."""
    return os.environ.get('SOAK_DATA') or path.join(ROOT, 'build', 'soak', 'data')


def make_soak_corpus(base: str | None = None) -> str:
    """Write the corpus under ``base`` (default ``default_dir()``) unless it
    is there already; returns ``base``, the ``MARGIPOSE_BASE_DATA_DIR`` of
    the soaks' ``fake`` variants."""
    base = base or default_dir()
    sentinel = path.join(base, SENTINEL)
    if path.isfile(sentinel):
        print(f'soak corpus already at {base}')
        return base
    for part in PARTS:  # what an interrupted generation left
        shutil.rmtree(path.join(base, part), ignore_errors=True)
    # larger than the test fakes so long soaks see some variety
    generate_fake_mpi3d(path.join(base, 'mpi3d', 'train'),
                        seqs=((1, 1), (2, 1)), camera_ids=(0, 2), n_frames=6)
    generate_fake_mpi3d(path.join(base, 'mpi3d', 'val'),
                        seqs=((3, 1),), camera_ids=(0,), n_frames=4, seed=1)
    generate_fake_mpii(path.join(base, 'mpii'), n_train=16, n_val=4, img_size=512)
    with open(sentinel, 'w'):
        pass
    print(f'soak corpus at {base}')
    return base


def use_fake_corpus(base: str | None = None) -> str:
    """Make the corpus (``make_soak_corpus``) and point this process and
    the processes it starts at it: ``MARGIPOSE_BASE_DATA_DIR``, and
    ``MARGIPOSE_RESOURCES_DIR`` (the checkout's ``resources/`` unless set)."""
    base = make_soak_corpus(base)
    os.environ['MARGIPOSE_BASE_DATA_DIR'] = base
    os.environ.setdefault('MARGIPOSE_RESOURCES_DIR', path.join(ROOT, 'resources'))
    return base
