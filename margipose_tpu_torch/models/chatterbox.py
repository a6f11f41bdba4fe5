"""Chatterbox: single-stage architecture with axis-collapsing z heads, NCHW.

Counterpart of ``margipose_tpu/models/chatterbox.py`` (reference:
src/margipose/models/chatterbox_model.py:13-303). ResNet-34 stem; the xy head
is a dilated ResNet layer3/4 (stride->dilation surgery); the zy/xz heads are
"chatterbox" CNNs that collapse one spatial axis to width 1 and
transpose-convolve back up. The state_dict keys are the reference's
(``down_convs.N``, ``up_convs.N``, ``resample.N``). Its one stage's three
planes reach the loss through ``margipose_masked_loss``, and so through one
``dsnt_jsd_grouped`` call of 3 groups a batch.
"""

from __future__ import annotations

from torch import nn

from margipose_tpu_torch.models.layers import BatchNorm2d, init_parameters
from margipose_tpu_torch.models.margipose import ModelOutput, heatmaps_to_coords
from margipose_tpu_torch.models.resnet import (
    ResLayer,
    ResNet34FeatureExtractor,
    _basic_layer_cfgs,
)
from margipose_tpu_torch.ops.dsnt import flat_softmax

Default_Chatterbox_Desc = {
    'type': 'chatterbox',
    'version': '1.3.0',
    'settings': {
        'pixelwise_loss': 'jsd',
    },
}


class XYCnn(nn.Module):
    """Dilated ResNet-34 layer3+layer4 + 1x1 heatmap conv
    (reference: src/margipose/models/chatterbox_model.py:56-83).

    Surgery: the stride-2 convs become stride 1 (keeping dilation 1); the
    other 3x3 convs get dilation 2 (layer3) / 4 (layer4)."""

    def __init__(self, n_joints: int):
        super().__init__()
        self.layer1 = ResLayer(128, _basic_layer_cfgs(6, 256, 2, True, dilate_stride_block=True,
                                                      dilation=2))
        self.layer2 = ResLayer(256, _basic_layer_cfgs(3, 512, 2, True, dilate_stride_block=True,
                                                      dilation=4))
        self.hm_conv = nn.Conv2d(512, n_joints, 1, bias=False)

    def forward(self, x):
        return self.hm_conv(self.layer2(self.layer1(x)))


class CbDownBlock(nn.Module):
    """(reference: src/margipose/models/chatterbox_model.py:130-168)"""

    def __init__(self, in_ch: int, features: int, stride=(1, 1), dilation=(1, 1),
                 dilation_in=None):
        super().__init__()
        dilation_in = dilation if dilation_in is None else dilation_in
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=dilation_in,
                               dilation=dilation_in, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(features)
        self.resample = None
        if tuple(stride) != (1, 1) or in_ch != features:
            self.resample = nn.Sequential(
                nn.Conv2d(in_ch, features, 1, stride=stride, bias=False), BatchNorm2d(features))

    def forward(self, x):
        out = self.bn1(self.conv1(x)).relu_()
        out = self.bn2(self.conv2(out))
        residual = x if self.resample is None else self.resample(x)
        return (out + residual).relu_()


class CbUpBlock(nn.Module):
    """(reference: src/margipose/models/chatterbox_model.py:170-211)"""

    def __init__(self, in_ch: int, features: int, stride=(1, 1), dilation=(1, 1),
                 dilation_in=None, output_padding=(0, 0)):
        super().__init__()
        dilation_in = dilation if dilation_in is None else dilation_in
        self.conv1 = nn.ConvTranspose2d(in_ch, features, 3, stride=stride, padding=dilation_in,
                                        output_padding=output_padding, dilation=dilation_in,
                                        bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(features)
        self.resample = None
        if tuple(stride) != (1, 1) or in_ch != features:
            self.resample = nn.Sequential(
                nn.ConvTranspose2d(in_ch, features, 1, stride=stride,
                                   output_padding=output_padding, bias=False),
                BatchNorm2d(features))

    def forward(self, x):
        out = self.bn1(self.conv1(x)).relu_()
        out = self.bn2(self.conv2(out))
        residual = x if self.resample is None else self.resample(x)
        return (out + residual).relu_()


class ChatterboxCnn(nn.Module):
    """Collapse one spatial axis to 1, then transpose back
    (reference: src/margipose/models/chatterbox_model.py:86-220).

    With ``shrink_width`` the width collapses (128x32x32 -> 1024x32x1 ->
    n_joints x32x32), else the height: each (a, b) pair below is (a, b) or
    (b, a), as the reference's f(a, b)."""

    def __init__(self, n_joints: int, shrink_width: bool = True):
        super().__init__()

        def f(a, b):
            return (a, b) if shrink_width else (b, a)

        self.down_convs = nn.Sequential(
            CbDownBlock(128, 256, stride=f(1, 2), dilation=f(2, 1), dilation_in=f(1, 1)),
            CbDownBlock(256, 256, dilation=f(2, 1)),
            CbDownBlock(256, 512, stride=f(1, 2), dilation=f(4, 1), dilation_in=f(2, 1)),
            CbDownBlock(512, 512, dilation=f(4, 1)),
            nn.Conv2d(512, 1024, f(1, 8), bias=False),
            BatchNorm2d(1024),
            nn.ReLU(inplace=True),
        )
        self.up_convs = nn.Sequential(
            nn.ConvTranspose2d(1024, 512, f(1, 8), bias=False),
            BatchNorm2d(512),
            nn.ReLU(inplace=True),
            CbUpBlock(512, 512, dilation=f(4, 1)),
            CbUpBlock(512, 256, stride=f(1, 2), dilation=f(2, 1), dilation_in=f(4, 1),
                      output_padding=f(0, 1)),
            CbUpBlock(256, 256, dilation=f(2, 1)),
            CbUpBlock(256, 128, stride=f(1, 2), dilation=f(1, 1), dilation_in=f(2, 1),
                      output_padding=f(0, 1)),
            nn.Conv2d(128, n_joints, 1, bias=False),
        )

    def forward(self, x):
        return self.up_convs(self.down_convs(x))


class ChatterboxModel(nn.Module):
    """(reference: src/margipose/models/chatterbox_model.py:223-289)"""

    def __init__(self, n_joints=17, pixelwise_loss='jsd', generator=None):
        super().__init__()
        self.pixelwise_loss = pixelwise_loss
        self.in_cnn = ResNet34FeatureExtractor()
        self.xy_hm_cnn = XYCnn(n_joints)
        self.zy_hm_cnn = ChatterboxCnn(n_joints, shrink_width=True)
        self.xz_hm_cnn = ChatterboxCnn(n_joints, shrink_width=False)
        init_parameters(self, generator)

    def forward(self, x):
        t = self.in_cnn(x)
        # softmax in f32, whatever the compute type
        out = ModelOutput(*((flat_softmax(head(t).float()),)
                            for head in (self.xy_hm_cnn, self.zy_hm_cnn, self.xz_hm_cnn)))
        xyz = heatmaps_to_coords(out.xy_heatmaps[-1], out.zy_heatmaps[-1], out.xz_heatmaps[-1])
        return xyz, out
