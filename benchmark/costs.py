"""The yardstick's arithmetic: peaks of the card, FLOPs of a forward, bytes
of the loss-head kernels, all from shapes.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
batch-1 forward of the configuration's frozen reference on the ``meta``
device (no arithmetic is done), as the port's bench counted them on the port
(``margipose_tpu_torch/bench.py`` ``flops_per_image``); a trained image
costs three forwards. Each configuration file keeps its count
(``flops_per_image``), so the yardstick does not move with the program;
``tests/test_bench_costs.py`` holds the two together.

The loss head (``csrc/dsnt_jsd.cu``) works on ``rows`` = groups x batch x
joints heatmaps of H x W float32. Its least traffic, each input read once
and each output written once: the forward reads the heatmaps and the [rows,
2] targets and writes [rows, 4] result rows; the backward reads the
heatmaps, the targets and the [rows, 4] cotangent and writes the heatmaps'
gradient.
"""

import torch

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W: bf16 on the
# tensor cores, float32 outside them (TF32 off), and HBM3 bandwidth
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def forward_flops(config):
    """FLOPs of one batch-1 forward of ``config``'s reference."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import reference

    size = config['input_size']
    with torch.device('meta'):
        model = reference.build(config['reference']).eval()
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.empty(1, 3, size, size))
    return float(counter.get_total_flops())


def loss_head_rows(config, batch):
    return config['loss_head_groups'] * batch * config['n_joints']


def dsnt_jsd_fwd_bytes(rows, h, w):
    return rows * h * w * F32 + rows * 2 * F32 + rows * 4 * F32


def dsnt_jsd_bwd_bytes(rows, h, w):
    return rows * h * w * F32 + rows * 2 * F32 + rows * 4 * F32 + rows * h * w * F32


def bound_seconds(nbytes):
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / PEAK_BYTES_PER_S
