"""The plain reference Chatterbox v1.3.0, float32 PyTorch.

Written from the published architecture (reference:
src/margipose/models/chatterbox_model.py:13-303, the baseline of Nibali et
al., arXiv:1806.01484), with the reference state_dict keys:

  * ``in_cnn``: torchvision ResNet-34's conv1 .. layer2 (3, 4 basic blocks)
    (chatterbox_model.py:36-53);
  * ``xy_hm_cnn``: ResNet-34's layer3 and layer4 with the stride->dilation
    surgery (the stride-2 conv becomes stride 1 with dilation 1, the other
    3x3 convs get dilation 2 in layer3 and 4 in layer4), then a 1x1 conv to
    the joints (chatterbox_model.py:56-83);
  * ``zy_hm_cnn`` / ``xz_hm_cnn``: the "chatterbox" CNNs that collapse the
    width (zy) or the height (xz) to 1 and transpose-convolve back up
    (chatterbox_model.py:86-220);
  * flat softmax and DSNT per plane; z is the mean of the zy and xz
    marginals' z (chatterbox_model.py:223-289).

Every batch norm is torch's own. Nothing here imports the port or the JAX
package.
"""

from torch import nn

from benchmark.reference.margipose import t_flat_softmax, t_heatmaps_to_coords


class BasicBlock(nn.Module):
    """torchvision's BasicBlock, each 3x3 conv with its own dilation
    (padding = dilation)."""

    def __init__(self, in_ch, out_ch, stride=1, d1=1, d2=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, padding=d1, dilation=d1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=d2, dilation=d2, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU()
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), nn.BatchNorm2d(out_ch))

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


def resnet_layer(in_ch, out_ch, n_blocks, stride=1, dilation=None):
    """A torchvision layer group; with ``dilation`` the stride->dilation
    surgery: block 0 keeps stride 1 and dilation 1 in its first conv."""
    if dilation is None:
        blocks = [BasicBlock(in_ch, out_ch, stride, downsample=stride != 1 or in_ch != out_ch)]
        blocks += [BasicBlock(out_ch, out_ch) for _ in range(n_blocks - 1)]
    else:
        blocks = [BasicBlock(in_ch, out_ch, 1, 1, dilation, downsample=True)]
        blocks += [BasicBlock(out_ch, out_ch, 1, dilation, dilation) for _ in range(n_blocks - 1)]
    return nn.Sequential(*blocks)


class ResNet34Stem(nn.Module):
    """conv1 .. layer2 of ResNet-34: 3x256x256 -> 128x32x32."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = resnet_layer(64, 64, 3)
        self.layer2 = resnet_layer(64, 128, 4, stride=2)

    def forward(self, x):
        return self.layer2(self.layer1(self.maxpool(self.relu(self.bn1(self.conv1(x))))))


class XYHead(nn.Module):
    def __init__(self, n_joints):
        super().__init__()
        self.layer1 = resnet_layer(128, 256, 6, dilation=2)
        self.layer2 = resnet_layer(256, 512, 3, dilation=4)
        self.hm_conv = nn.Conv2d(512, n_joints, 1, bias=False)

    def forward(self, x):
        return self.hm_conv(self.layer2(self.layer1(x)))


class CbBlock(nn.Module):
    """A chatterbox residual block: conv1 (strided; transposed in the up
    path), bn1, ReLU, conv2, bn2, plus the input or its 1x1 resample."""

    def __init__(self, in_ch, out_ch, stride=(1, 1), dilation=(1, 1), dilation_in=None,
                 up=False, output_padding=(0, 0)):
        super().__init__()
        dilation_in = dilation if dilation_in is None else dilation_in
        if up:
            self.conv1 = nn.ConvTranspose2d(in_ch, out_ch, 3, stride, padding=dilation_in,
                                            output_padding=output_padding,
                                            dilation=dilation_in, bias=False)
        else:
            self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, padding=dilation_in,
                                   dilation=dilation_in, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU()
        self.resample = None
        if tuple(stride) != (1, 1) or in_ch != out_ch:
            conv = (nn.ConvTranspose2d(in_ch, out_ch, 1, stride, output_padding=output_padding,
                                       bias=False) if up
                    else nn.Conv2d(in_ch, out_ch, 1, stride, bias=False))
            self.resample = nn.Sequential(conv, nn.BatchNorm2d(out_ch))

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.resample is None else self.resample(x)
        return self.relu(out + residual)


class ChatterboxHead(nn.Module):
    """Collapse the width (``shrink_width``) or the height to 1, then back:
    each (a, b) below is (a, b) for the width and (b, a) for the height."""

    def __init__(self, n_joints, shrink_width):
        super().__init__()

        def f(a, b):
            return (a, b) if shrink_width else (b, a)

        self.down_convs = nn.Sequential(
            CbBlock(128, 256, f(1, 2), f(2, 1), f(1, 1)),
            CbBlock(256, 256, dilation=f(2, 1)),
            CbBlock(256, 512, f(1, 2), f(4, 1), f(2, 1)),
            CbBlock(512, 512, dilation=f(4, 1)),
            nn.Conv2d(512, 1024, f(1, 8), bias=False),
            nn.BatchNorm2d(1024),
            nn.ReLU(),
        )
        self.up_convs = nn.Sequential(
            nn.ConvTranspose2d(1024, 512, f(1, 8), bias=False),
            nn.BatchNorm2d(512),
            nn.ReLU(),
            CbBlock(512, 512, dilation=f(4, 1), up=True),
            CbBlock(512, 256, f(1, 2), f(2, 1), f(4, 1), up=True, output_padding=f(0, 1)),
            CbBlock(256, 256, dilation=f(2, 1), up=True),
            CbBlock(256, 128, f(1, 2), f(1, 1), f(2, 1), up=True, output_padding=f(0, 1)),
            nn.Conv2d(128, n_joints, 1, bias=False),
        )

    def forward(self, x):
        return self.up_convs(self.down_convs(x))


class TChatterbox(nn.Module):
    """forward(x) -> (xyz [B, J, 3], ([xy], [zy], [xz])): one stage's
    normalised heatmaps per plane, as ``TMargiPose`` returns its stages'."""

    def __init__(self, n_joints=17):
        super().__init__()
        self.in_cnn = ResNet34Stem()
        self.xy_hm_cnn = XYHead(n_joints)
        self.zy_hm_cnn = ChatterboxHead(n_joints, shrink_width=True)
        self.xz_hm_cnn = ChatterboxHead(n_joints, shrink_width=False)

    def forward(self, x):
        t = self.in_cnn(x)
        hms = tuple([t_flat_softmax(head(t))]
                    for head in (self.xy_hm_cnn, self.zy_hm_cnn, self.xz_hm_cnn))
        return t_heatmaps_to_coords(hms[0][0], hms[1][0], hms[2][0]), hms
