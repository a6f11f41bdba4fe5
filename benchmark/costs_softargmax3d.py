"""The bytes the volumetric soft-argmax kernels (``csrc/softargmax3d.cu``)
must move at least, and their share of that bound in a traced run.

The kernels work on ``rows`` = batch x joints volumes of ``volume`` = D x H
x W logits of ``width`` bytes (2 for bf16, 4 for float32). Each input read
once and each output written once: the forward reads the logits and writes
[rows, 3] coordinates and [rows, 2] statistics, float32; the backward reads
the logits, the coordinates, the statistics and the [rows, 3] cotangent and
writes the logits' gradient. At the integral cell's batch of 32 (544 rows of
64^3, bf16) that is 285 MB, 85 us at the card's bandwidth, forward, and
570 MB, 170 us, backward.
"""

from benchmark import costs
from benchmark.readers import kernel_seconds

F32 = 4


def fwd_bytes(rows, volume, width):
    return rows * volume * width + rows * 5 * F32


def bwd_bytes(rows, volume, width):
    return 2 * rows * volume * width + rows * 8 * F32


def roofline(obs, direction):
    """The ``direction`` ('fwd' or 'bwd') kernel's share of its bytes bound,
    %: the least time its shapes' traffic takes at the card's bandwidth over
    its mean traced time a launch; None where the trace holds no launch of
    it."""
    launches, seconds = kernel_seconds(obs, f'softargmax3d_{direction}_kernel')
    c = obs.get('costs', {}).get('softargmax3d')
    if not launches or seconds <= 0 or not c:
        return None
    nbytes = (fwd_bytes if direction == 'fwd' else bwd_bytes)(c['rows'], c['volume'], c['width'])
    return 100.0 * costs.bound_seconds(nbytes) / (seconds / launches)
