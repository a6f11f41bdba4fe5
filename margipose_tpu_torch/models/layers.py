"""NCHW building blocks with the reference torch ``state_dict`` layout.

Counterparts of ``margipose_tpu/models/layers.py`` and ``ops/convs.py``:
convolution, batch norm, ReLU and pooling are torch's own modules (cuDNN on
the card). Child names follow the reference Sequential indices, so the
port's keys are the keys ``margipose_tpu.train.torch_import`` exports.
"""

from __future__ import annotations

from torch import nn


class BasicConv2d(nn.Module):
    """Conv (no bias) + BN(eps=1e-3) + ReLU, as in pretrainedmodels'
    InceptionV4. Children: conv, bn."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

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
            _conv_in(in_ch, out_ch, kind, 3), nn.BatchNorm2d(out_ch), nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False), nn.BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )
        self.shortcut = nn.Sequential(_conv_in(in_ch, out_ch, kind, 1), nn.BatchNorm2d(out_ch))

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
