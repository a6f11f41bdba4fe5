"""InceptionV4 stem (feature blocks 0-6) with 'same'-ified padding, NCHW.

Counterpart of ``margipose_tpu/models/inception.py``: the first 7 blocks of
pretrainedmodels' ``inceptionv4().features`` with every Conv2d/MaxPool2d
padding forced to ``kernel_size // 2``, then a 1x1 conv to 128 channels + BN
+ ReLU (reference: src/margipose/models/margipose_model.py:103-118).
Input 3x256x256 -> 128 channels at 32x32.
"""

from __future__ import annotations

import torch
from torch import nn

from margipose_tpu_torch.models.layers import BasicConv2d, BatchNorm2d


class Mixed3a(nn.Module):
    def __init__(self):
        super().__init__()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.conv = BasicConv2d(64, 96, 3, stride=2, padding=1)

    def forward(self, x):
        return torch.cat([self.maxpool(x), self.conv(x)], 1)


class Mixed4a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(
            BasicConv2d(160, 64, 1),
            BasicConv2d(64, 96, 3, padding=1),
        )
        self.branch1 = nn.Sequential(
            BasicConv2d(160, 64, 1),
            BasicConv2d(64, 64, (1, 7), padding=(0, 3)),
            BasicConv2d(64, 64, (7, 1), padding=(3, 0)),
            BasicConv2d(64, 96, 3, padding=1),
        )

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], 1)


class Mixed5a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = BasicConv2d(192, 192, 3, stride=2, padding=1)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return torch.cat([self.conv(x), self.maxpool(x)], 1)


class InceptionA(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(384, 96, 1)
        self.branch1 = nn.Sequential(
            BasicConv2d(384, 64, 1),
            BasicConv2d(64, 96, 3, padding=1),
        )
        self.branch2 = nn.Sequential(
            BasicConv2d(384, 64, 1),
            BasicConv2d(64, 96, 3, padding=1),
            BasicConv2d(96, 96, 3, padding=1),
        )
        self.branch3 = nn.Sequential(
            nn.AvgPool2d(3, stride=1, padding=1, count_include_pad=False),
            BasicConv2d(384, 96, 1),
        )

    def forward(self, x):
        return torch.cat(
            [self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


def inception_in_cnn() -> nn.Sequential:
    """InceptionV4 blocks 0-6 + Conv1x1(384->128) + BN + ReLU, indexed as the
    reference Sequential ('0'..'8'; margipose_model.py:103-118)."""
    return nn.Sequential(
        BasicConv2d(3, 32, 3, stride=2, padding=1),
        BasicConv2d(32, 32, 3, padding=1),
        BasicConv2d(32, 64, 3, padding=1),
        Mixed3a(),
        Mixed4a(),
        Mixed5a(),
        InceptionA(),
        nn.Conv2d(384, 128, 1),
        BatchNorm2d(128),
        nn.ReLU(inplace=True),
    )
