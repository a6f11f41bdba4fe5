"""ResNet-18/34/50 trunks (conv1 .. layer2) and dilated layer3/4 groups, NCHW.

Counterpart of ``margipose_tpu/models/resnet.py``: the torchvision ResNet
pieces the reference uses as stems (reference:
src/margipose/models/margipose_model.py:119-138 and
src/margipose/models/chatterbox_model.py:36-83). Attribute names are the
torchvision state_dict's (conv1/bn1/layer1.0.conv1/... and
downsample.0/.1); every batch norm is ``layers.BatchNorm2d``, which folds
the biased batch variance into its running variance, as the JAX package's
does.
"""

from __future__ import annotations

from torch import nn

from margipose_tpu_torch.models.layers import BatchNorm2d


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    """1x1 conv + BN shortcut; keys downsample.0 / downsample.1."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                         BatchNorm2d(out_ch))


class BasicBlock(nn.Module):
    """torchvision BasicBlock; optionally dilated (the chatterbox surgery).

    ``dilation1``/``dilation2`` apply to conv1/conv2 with padding ==
    dilation, as the stride->dilation surgery at
    src/margipose/models/chatterbox_model.py:56-71 leaves them."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation1: int = 1,
                 dilation2: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=dilation1,
                               dilation=dilation1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=dilation2, dilation=dilation2,
                               bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = _downsample(in_ch, features, stride) if has_downsample else None

    def forward(self, x):
        out = self.bn1(self.conv1(x)).relu_()
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return (out + identity).relu_()


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4); stride on conv2."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(in_ch, planes * 4, stride) if has_downsample
                           else None)

    def forward(self, x):
        out = self.bn1(self.conv1(x)).relu_()
        out = self.bn2(self.conv2(out)).relu_()
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return (out + identity).relu_()


class ResLayer(nn.Sequential):
    """A torchvision layer group: blocks '0', '1', ... from their configs."""

    def __init__(self, in_ch: int, block_cfgs, block_cls=BasicBlock):
        blocks = []
        for cfg in block_cfgs:
            blocks.append(block_cls(in_ch, **cfg))
            in_ch = cfg.get("features", cfg.get("planes")) * block_cls.expansion
        super().__init__(*blocks)
        self.out_channels = in_ch


# Number of blocks per layer group for each variant.
RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
}


def _basic_layer_cfgs(n_blocks: int, features: int, stride: int, first_has_ds: bool,
                      dilate_stride_block: bool = False, dilation: int = 1):
    """Configs for a BasicBlock layer group; optionally with the chatterbox
    stride->dilation surgery applied (stride 2 -> 1; 3x3 stride-1 convs get
    ``dilation``; the former stride-2 conv1 keeps dilation 1)."""
    cfgs = []
    for i in range(n_blocks):
        if i == 0:
            if dilate_stride_block:
                cfgs.append(dict(features=features, stride=1, dilation1=1,
                                 dilation2=dilation, has_downsample=first_has_ds))
            else:
                cfgs.append(dict(features=features, stride=stride,
                                 has_downsample=first_has_ds))
        else:
            d = dilation if dilate_stride_block else 1
            cfgs.append(dict(features=features, dilation1=d, dilation2=d))
    return cfgs


def _bottleneck_layer_cfgs(n_blocks: int, planes: int, stride: int):
    cfgs = [dict(planes=planes, stride=stride, has_downsample=True)]
    cfgs += [dict(planes=planes) for _ in range(n_blocks - 1)]
    return cfgs


class ResNetStem(nn.Sequential):
    """conv1 .. layer2 of a torchvision ResNet, plus a 1x1 reduction to 128
    channels for resnet50, as a margipose feature extractor
    (reference: src/margipose/models/margipose_model.py:119-138).

    Indices are the reference wrapper's: 0 conv1, 1 bn1, 2 relu, 3 maxpool,
    4 layer1, 5 layer2; for resnet50, 6 a 1x1 conv with bias and 7 its BN
    (8 the ReLU). 256x256 input -> 128 channels at 32x32."""

    def __init__(self, variant: str = "resnet18"):
        n1, n2, _, _ = RESNET_LAYERS[variant]
        if variant == "resnet50":
            layers = [ResLayer(64, _bottleneck_layer_cfgs(n1, 64, 1), Bottleneck)]
            layers.append(ResLayer(layers[0].out_channels, _bottleneck_layer_cfgs(n2, 128, 2),
                                   Bottleneck))
            layers += [nn.Conv2d(layers[1].out_channels, 128, 1), BatchNorm2d(128),
                       nn.ReLU(inplace=True)]
        else:
            layers = [ResLayer(64, _basic_layer_cfgs(n1, 64, 1, False)),
                      ResLayer(64, _basic_layer_cfgs(n2, 128, 2, True))]
        super().__init__(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), BatchNorm2d(64),
            nn.ReLU(inplace=True), nn.MaxPool2d(3, stride=2, padding=1), *layers)


class ResNet34FeatureExtractor(nn.Module):
    """conv1 .. layer2 of ResNet-34 with torchvision attribute names, as the
    chatterbox stem (reference: src/margipose/models/chatterbox_model.py:36-53)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = ResLayer(64, _basic_layer_cfgs(3, 64, 1, False))
        self.layer2 = ResLayer(64, _basic_layer_cfgs(4, 128, 2, True))

    def forward(self, x):
        x = self.maxpool(self.bn1(self.conv1(x)).relu_())
        return self.layer2(self.layer1(x))
