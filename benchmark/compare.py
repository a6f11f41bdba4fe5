"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference gives for the same inputs.

Norms are compared leaf by leaf (a leaf is one parameter tensor): the gap of
a leaf is |program's norm - reference's norm| over the larger of the
reference's norm of that leaf and of the median leaf. The training cells
compare the median leaf's gap; the worst leaf's is logged beside it. (The
worst leaf is a stem batch norm's weight or bias, whose gradient sums half
a million terms of both signs: in bf16 it reads 0.2-0.4 on every seed, as
far from the reference as fp8 reads. ``PERF.md`` gives the readings.)
Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias that batch norm cancels moves by round-off alone) are left out.
"""

import numpy as np

NEGLIGIBLE = 1e-3


def kept_leaves(ref_grad):
    """Names of the leaves that count, by the reference's first gradient."""
    median = float(np.median(list(ref_grad.values())))
    return sorted(k for k, v in ref_grad.items() if v >= NEGLIGIBLE * median)


def leaf_gaps(program, ref, leaves):
    """Each leaf's gap of the per-leaf norms ``program`` against ``ref``
    (dicts by name; a leaf the program lacks counts as 0)."""
    median = float(np.median([ref[k] for k in leaves]))
    return np.array([abs(program.get(k, 0.0) - ref[k]) / max(ref[k], median) for k in leaves])


def relative(program, ref):
    """The largest |program - ref| / |ref| over paired scalars."""
    program, ref = np.asarray(program, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(program - ref) / np.abs(ref)))


def widest(program, ref):
    """The largest |program - ref| over paired arrays."""
    return float(np.max(np.abs(np.asarray(program, np.float64) - np.asarray(ref, np.float64))))


def answer_gaps(program, ref):
    """Each answer's widest coordinate gap: ``program`` and ``ref`` [N, J, 3]."""
    diff = np.abs(np.asarray(program, np.float64) - np.asarray(ref, np.float64))
    return diff.reshape(len(diff), -1).max(-1)


def train_readings(program, ref):
    """``program`` and ``ref``: {'losses': the first steps' losses,
    'pred': the first step's coordinates [B, J, 3], 'grad': the first
    gradient's norm by leaf, 'change': the norm by leaf of each parameter's
    change over those steps}. Returns (the readings compared, the worst
    leaves' gaps)."""
    leaves = kept_leaves(ref['grad'])
    grad = leaf_gaps(program['grad'], ref['grad'], leaves)
    change = leaf_gaps(program['change'], ref['change'], leaves)
    worst = {'grad_gap_worst_leaf': float(grad.max()), 'update_gap_worst_leaf': float(change.max())}
    return ({'loss_gap': relative(program['losses'], ref['losses']),
             'pred_gap': float(answer_gaps(program['pred'], ref['pred']).mean()),
             'grad_gap': float(np.median(grad)), 'update_gap': float(np.median(change))}, worst)
