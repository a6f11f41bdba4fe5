"""NCHW building blocks with the reference torch ``state_dict`` layout.

Counterparts of ``margipose_tpu/models/layers.py`` and ``ops/convs.py``:
convolution, batch norm, ReLU and pooling are torch's own modules (cuDNN on
the card). Child names follow the reference Sequential indices, so the
port's keys are the keys ``margipose_tpu.train.torch_import`` exports.
"""

from __future__ import annotations

import torch
from torch import nn

from margipose_tpu_torch.parallel import mesh


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode ``running_var`` takes in the biased
    batch variance, as the JAX package's BatchNorm (flax) does, and whose
    train-mode statistics span the global batch while a process group is
    active (``parallel/mesh.py``), as flax's do under the JAX package's
    shard_map steps (``axis_name`` from ``current_shard_axis()``): the rows
    of the processes in ``process_group``, the mesh's 'data' group once
    ``mesh.shard_variables`` has placed the model (None: every process).

    Both frameworks normalise with the biased batch variance; torch folds the
    unbiased one into ``running_var``, a factor n/(n-1) with n = B*H*W per
    channel. The fix-up needs no second pass over the activation: with f the
    EMA factor, torch leaves ``new = (1-f) old + f var_u``, and
    ``new - (new - (1-f) old) / n`` is ``(1-f) old + f var_u (n-1)/n``.
    """

    process_group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if mesh.group_active():
            return self._global_forward(x)
        old = self.running_var.clone()
        out = super().forward(x)  # updates the stats and num_batches_tracked
        n = x.numel() // x.shape[1]
        # through .data: autograd saved running_var with the batch-norm node
        # (its train-mode backward never reads it), and an in-place update of
        # the tracked tensor would fail the saved-version check
        var = self.running_var.data
        var.sub_((var - self._keep() * old) / n)
        return out

    def _keep(self):
        """1 - the EMA factor of this update (after num_batches_tracked's
        increment), as torch computes it."""
        if self.momentum is None:  # cumulative average
            return 1.0 - 1.0 / self.num_batches_tracked.to(self.running_var.dtype)
        return 1.0 - self.momentum

    def _global_forward(self, x):
        """Train-mode batch norm over the group's rows. Per channel,
        [sum, sum of squares] and the row count go through one differentiable
        all-reduce (its backward all-reduces the gradients, so each process's
        input gradient has the other processes' terms); then flax's one-pass
        statistics, mean E[x] and biased variance E[x^2] - E[x]^2 in float32,
        normalise the input and are folded into the running stats. Stock
        ``nn.SyncBatchNorm`` refuses CPU tensors and folds the unbiased
        variance."""
        c = x.shape[1]
        xf = x.float()
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        stats = mesh.all_reduce_sum(
            torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)), count]),
            self.process_group)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean.square()).clamp(min=0.0)
        scale = torch.rsqrt(var + self.eps)
        shift = -mean * scale
        if self.affine:
            scale, shift = scale * self.weight, shift * self.weight + self.bias
        out = xf * scale[:, None, None] + shift[:, None, None]
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            keep = self._keep()
            self.running_mean.mul_(keep).add_((1.0 - keep) * mean.detach())
            self.running_var.mul_(keep).add_((1.0 - keep) * var.detach())
        return out.to(x.dtype)


class BasicConv2d(nn.Module):
    """Conv (no bias) + BN(eps=1e-3) + ReLU, as in pretrainedmodels'
    InceptionV4. Children: conv, bn."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return self.bn(self.conv(x)).relu_()


def _conv_in(in_ch, out_ch, kind, kernel_size):
    """First conv of a residual branch: regular, strided ('down') or
    transposed ('up'). The 3x3 main branch pads 1; the 1x1 shortcut pads 0
    (reference: src/margipose/models/margipose_model.py:25-40)."""
    padding = kernel_size // 2
    if kind == 'regular':
        return nn.Conv2d(in_ch, out_ch, kernel_size, padding=padding, bias=False)
    if kind == 'down':
        return nn.Conv2d(in_ch, out_ch, kernel_size, stride=2, padding=padding, bias=False)
    if kind == 'up':
        return nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride=2, padding=padding,
                                  output_padding=1, bias=False)
    raise ValueError(kind)


class ResidualBlock(nn.Module):
    """main(x) + shortcut(x). ``module`` is conv_in, bn, relu, 3x3 conv, bn,
    relu (indices 0-5); ``shortcut`` is a 1x1 conv_in + bn (indices 0-1)."""

    def __init__(self, in_ch, out_ch, kind='regular'):
        super().__init__()
        self.module = nn.Sequential(
            _conv_in(in_ch, out_ch, kind, 3), BatchNorm2d(out_ch), nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False), BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )
        self.shortcut = nn.Sequential(_conv_in(in_ch, out_ch, kind, 1), BatchNorm2d(out_ch))

    def forward(self, x):
        return self.module(x) + self.shortcut(x)


def init_parameters(module: nn.Module, generator=None) -> None:
    """Reference initialisation (src/margipose/nn_helpers.py:7-21):
    Kaiming-normal fan_out for convs, BN weight 1 / bias 0, zero conv bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_normal_(m.weight, mode='fan_out', nonlinearity='relu',
                                    generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
