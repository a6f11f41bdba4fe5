"""The plain reference Integral Human Pose Regression, float32 PyTorch.

Written from the published 3D configuration (Sun, Xiao, Wei, Liang and
Wei, ECCV 2018, arXiv:1711.08229; code: github.com/JimmySuen/integral-human-pose,
``ResPoseNet``), with the port's state_dict keys:

  * ``backbone``: torchvision's ResNet-50 without its avgpool and fc: conv1,
    bn1, maxpool, layer1..layer4 of Bottleneck blocks (3, 4, 6, 3), the
    stride on conv2 of a block;
  * ``head.features``: three ConvTranspose2d(k=4, stride=2, padding=1, no
    bias) of 256 filters, each followed by BatchNorm2d and ReLU, then a 1x1
    Conv2d with bias to J * D channels, read as J volumes [D, H, W]
    (channel j * D + d);
  * the soft-argmax: a softmax over each flattened volume, then the
    expectations of the voxel centres along W (x), H (y) and D (z);
  * the L1 loss on the coordinates, x and y alone for a 2D row.

Departures from the paper: the voxel centres are (2i + 1)/n - 1, the
system's [-1, 1] target space, twice the paper's [-0.5, 0.5]; ``train_step``
takes 1cycle momentum SGD (``sgd.OneCycleSGD``), the port's train path's
optimiser, in place of Adam; 17 joints, the system's canonical skeleton.
Every batch norm is torch's own. Nothing here imports the port or the JAX
package.
"""

import torch
from torch import nn

from benchmark.reference.margipose import t_normalized_linspace


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (expansion 4), the stride on conv2."""

    def __init__(self, in_ch, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or in_ch != planes * 4:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, planes * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class TResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        in_ch = 64
        for i, (n_blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            stride = 1 if i == 0 else 2
            blocks = [Bottleneck(in_ch, planes, stride)]
            blocks += [Bottleneck(planes * 4, planes) for _ in range(n_blocks - 1)]
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            in_ch = planes * 4

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class TDeconvHead(nn.Module):
    def __init__(self, in_ch, out_ch, n_deconv=3, filters=256):
        super().__init__()
        layers = []
        for i in range(n_deconv):
            layers += [nn.ConvTranspose2d(in_ch if i == 0 else filters, filters, 4, 2, padding=1,
                                          bias=False),
                       nn.BatchNorm2d(filters), nn.ReLU()]
        layers.append(nn.Conv2d(filters, out_ch, 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x)


def t_softargmax3d(logits, depth):
    """[B, J * D, H, W] logits -> [B, J, 3]: the expected voxel centre under a
    softmax over each joint's flattened volume."""
    b, c, h, w = logits.shape
    j = c // depth
    p = logits.reshape(b, j, depth * h * w).softmax(-1).reshape(b, j, depth, h, w)
    cx = t_normalized_linspace(w, p.dtype, p.device)
    cy = t_normalized_linspace(h, p.dtype, p.device).view(h, 1)
    cz = t_normalized_linspace(depth, p.dtype, p.device).view(depth, 1, 1)
    return torch.stack([(p * cx).sum((2, 3, 4)), (p * cy).sum((2, 3, 4)),
                        (p * cz).sum((2, 3, 4))], -1)


class TIntegralPose(nn.Module):
    """``forward(x) -> (xyz [B, J, 3], logits [B, J * D, H, W])``."""

    def __init__(self, n_joints=17, depth_dim=64):
        super().__init__()
        self.depth_dim = depth_dim
        self.backbone = TResNet50()
        self.head = TDeconvHead(2048, n_joints * depth_dim)

    def forward(self, x):
        logits = self.head(self.backbone(x))
        return t_softargmax3d(logits, self.depth_dim), logits


def masked_l1_loss(xyz, target, mask, valid_depth):
    """The mean over the joints ``mask`` keeps (the denominator clipped at 1)
    of |dx| + |dy| + |dz| for a 3D row (``valid_depth`` 1), |dx| + |dy| for a
    2D row."""
    err = (xyz - target[..., :3]).abs()
    losses = torch.where(valid_depth[:, None] == 1, err.sum(-1), err[..., :2].sum(-1))
    return (losses * mask).sum() / mask.sum().clamp(min=1.0)


def train_step(model, optimiser, batch):
    """One step of ``model`` in train mode on ``batch`` (input [B, 3, H, W],
    target, joint_mask, valid_depth) with ``optimiser`` (an
    ``sgd.OneCycleSGD``): forward, masked L1 loss, backward, update. Returns
    the loss and the coordinates."""
    model.train()
    for p in optimiser.params:
        p.grad = None
    xyz, _ = model(batch['input'])
    loss = masked_l1_loss(xyz, batch['target'], batch['joint_mask'], batch['valid_depth'])
    loss.backward()
    optimiser.step()
    return loss.detach(), xyz.detach()
