"""Seeded weights in the reference's state_dict format, made on the device.

The reference model named by the configuration is laid out on ``meta``,
given storage on the device, and filled from one ``torch.Generator`` there
in a few large calls: Kaiming-normal (fan_out, ReLU) convolution weights
from one draw, zero biases, batch-norm weight 1 and bias 0
(src/margipose/nn_helpers.py:7-21). The batch-norm statistics are then
calibrated by the recipe of the port's bench (``margipose_tpu_torch/bench.py``
``randomize_batch_norm``): one train-mode pass over 8 seeded images with a
cumulative average, then each running mean shifted by 0.05 N(0, 1) and each
running variance scaled by U(0.8, 1.25), from one draw each. Last, the
configuration's ``scale_down`` entries name weights to scale, so that the
heatmaps are neither flat nor one-hot, as with trained weights (the
bench's 0.5 on the last residual block of every MargiPose column).
"""

import fnmatch
import math

import torch
from torch import nn

from benchmark import reference

CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def _fan_out(weight):
    """torch's fan_out of a convolution weight: dim 0 times the kernel."""
    return weight.shape[0] * math.prod(weight.shape[2:])


@torch.no_grad()
def seeded_reference(config, seed, device):
    """(reference model on ``device`` in eval mode, its state_dict on the
    device): the weights ``seed`` gives for ``config``."""
    with torch.device('meta'):
        model = reference.build(config['reference'])
    model = model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    convs = [m for m in model.modules() if isinstance(m, CONVS)]
    noise = torch.randn(sum(m.weight.numel() for m in convs), generator=g, device=device)
    offset = 0
    for m in convs:
        n = m.weight.numel()
        m.weight.copy_(noise[offset:offset + n].view_as(m.weight)
                       * math.sqrt(2.0 / _fan_out(m.weight)))
        offset += n
        if m.bias is not None:
            m.bias.zero_()
    del noise
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.reset_running_stats()
        bn.momentum = None  # a cumulative average: one pass gives the batch's statistics
    size = config['input_size']
    images = torch.randn(8, 3, size, size, generator=g, device=device)
    model.train()(images)
    model.eval()
    widths = [bn.num_features for bn in bns]
    shift = torch.randn(sum(widths), generator=g, device=device).split(widths)
    scale = torch.rand(sum(widths), generator=g, device=device).split(widths)
    for bn, s, r in zip(bns, shift, scale):
        bn.momentum = 0.1
        bn.running_mean.add_(0.05 * s)
        bn.running_var.mul_(0.8 + 0.45 * r)
    params = dict(model.named_parameters())
    for pattern, factor in config.get('scale_down', {}).items():
        for name in fnmatch.filter(params, pattern):
            params[name].mul_(factor)
    return model, model.state_dict()


def seeded_state_dict(config, seed, device):
    """``seeded_reference``'s state_dict alone, on ``device``, the model
    freed."""
    model, state_dict = seeded_reference(config, seed, device)
    state_dict = {k: v.clone() for k, v in state_dict.items()}
    del model
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return state_dict
