"""Integral Human Pose Regression: ResNet-50, deconvolutions, volumetric
heatmaps and their soft-argmax, NCHW.

Sun, Xiao, Wei, Liang and Wei, ECCV 2018, arXiv:1711.08229 (code:
github.com/JimmySuen/integral-human-pose, ``ResPoseNet``), the
volumetric-heatmap approach that MargiPose's marginal heatmaps are set
against. The published 3D configuration, every width kept:

  * ``backbone``: the torchvision ResNet-50 without its avgpool and fc
    (``resnet.ResNet50Trunk``), 256x256 -> 2048 channels at 8x8;
  * ``head.features``: three ``ConvTranspose2d(k=4, stride=2, padding=1,
    bias=False)`` of 256 filters, each with batch norm and ReLU (8x8 ->
    64x64), then a 1x1 ``Conv2d`` with bias to J * D channels, read as J
    volumes [D, H, W] (channel j * D + d);
  * the soft-argmax over each whole volume (``ops/softargmax3d``: the CUDA
    kernels on the card), whose expected voxel centre is the prediction, in
    the inference path too;
  * the L1 loss on the coordinates (x, y and z for a 3D row, x and y for a
    2D one), the masked mean over joints.

Departures: the voxel centres are ``normalized_linspace``'s (2i + 1)/n - 1,
so the coordinates live in the system's [-1, 1] target space, twice the
paper's [-0.5, 0.5]; 17 joints, the system's canonical skeleton. The
trunk's initialisation is the port's (Kaiming fan_out) where the paper
starts from ImageNet; the head's is the public code's (normal, std 0.001).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from margipose_tpu_torch.models.layers import BatchNorm2d, init_parameters
from margipose_tpu_torch.models.resnet import ResNet50Trunk
from margipose_tpu_torch.ops.batch_norm import channels_last
from margipose_tpu_torch.ops.dsnt import average_loss
from margipose_tpu_torch.ops.softargmax3d import softargmax3d

Default_Integral_Desc = {
    'type': 'integral',
    'version': '1.0.0',
    'settings': {
        'depth_dim': 64,
        'input_size': 256,
    },
}


class IntegralOutput(NamedTuple):
    """The head's logits ``[B, J * D, H, W]`` and their soft-argmax
    ``[B, J, 3]`` float32, which the loss reads."""

    logits: torch.Tensor
    xyz: torch.Tensor


class _OutputConv(torch.autograd.Function):
    """The head's 1x1 output convolution with bias of a channels-last x
    [B, C, H, W], as batched GEMMs that write the logits NCHW: [B, O, H * W]
    = [W | b] [O, C + 1] x [x | 1] [B, C + 1, H * W], the channels-last x a
    transposed operand, its row of ones appended in one copy (padded with
    zeros to a multiple of 8 for the tensor cores). The soft-argmax kernels
    read NCHW; a convolution would write channels-last logits (285 MB in
    the train cell) for a copy each way, and a separate bias add would pass
    over them once more. x's gradient comes back channels-last; the
    weight's and bias's are the batch's sum of per-image products."""

    @staticmethod
    @torch.amp.custom_fwd(device_type='cuda')
    def forward(ctx, x, weight, bias):
        b, c, h, w = x.shape
        o = weight.shape[0]
        pad = -(c + 1) % 8
        rows = x.permute(0, 2, 3, 1).reshape(b, h * w, c)  # a view of channels-last memory
        tail = x.new_zeros(1 + pad)  # made on the device (a fill, no copy): a graph captures it
        tail[:1].fill_(1.0)
        tail = tail.expand(b, h * w, 1 + pad)
        ones = torch.cat([rows, tail], -1)
        wb = torch.cat([weight.reshape(o, c), bias[:, None], bias.new_zeros(o, pad)], 1)
        ctx.save_for_backward(ones, weight)
        return torch.matmul(wb, ones.transpose(1, 2)).view(b, o, h, w)

    @staticmethod
    @torch.amp.custom_bwd(device_type='cuda')
    def backward(ctx, grad):
        ones, weight = ctx.saved_tensors
        b, o, h, w = grad.shape
        c = weight.shape[1]
        g = grad.reshape(b, o, h * w)
        dx = torch.matmul(g.transpose(1, 2), weight.reshape(o, c))  # [B, H * W, C]
        dwb = torch.matmul(g, ones).sum(0).to(weight.dtype)  # [O, C + 1 + pad]
        return (dx.view(b, h, w, c).permute(0, 3, 1, 2), dwb[:, :c].reshape(weight.shape),
                dwb[:, c])


class DeconvHead(nn.Module):
    """``features``: (ConvTranspose2d, BatchNorm2d, ReLU) x ``n_deconv``, then
    the 1x1 output conv with bias (the public code's ``DeconvHead``). Its
    output is NCHW whatever x's layout: a channels-last x takes the output
    conv as GEMMs (``_OutputConv``)."""

    def __init__(self, in_ch: int, n_deconv: int, filters: int, out_ch: int):
        super().__init__()
        layers = []
        for i in range(n_deconv):
            layers += [nn.ConvTranspose2d(in_ch if i == 0 else filters, filters, 4, stride=2,
                                          padding=1, output_padding=0, bias=False),
                       BatchNorm2d(filters), nn.ReLU(inplace=True)]
        layers.append(nn.Conv2d(filters, out_ch, 1, bias=True))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        *body, out = self.features
        for layer in body:
            x = layer(x)
        if channels_last(x):
            return _OutputConv.apply(x, out.weight, out.bias)
        return out(x)


class IntegralPoseModel(nn.Module):
    """``forward(x) -> (xyz [B, J, 3] float32, IntegralOutput)``."""

    def __init__(self, n_joints=17, depth_dim=64, deconv_filters=256, n_deconv=3,
                 generator=None):
        super().__init__()
        self.depth_dim = depth_dim
        self.backbone = ResNet50Trunk()
        self.head = DeconvHead(ResNet50Trunk.out_channels, n_deconv, deconv_filters,
                               n_joints * depth_dim)
        init_parameters(self.backbone, generator)
        for m in self.head.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.normal_(m.weight, std=0.001, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        logits = self.head(self.backbone(x))
        xyz = softargmax3d(logits, self.depth_dim)
        return xyz, IntegralOutput(logits, xyz)

    def joint_losses(self, out: IntegralOutput, target, valid_depth, pixelwise_loss=None):
        """Per-joint L1 losses [B, J] of ``out``'s coordinates: |dx| + |dy| +
        |dz| for a row with ``valid_depth`` 1, |dx| + |dy| for the others.
        There is no pixelwise term: ``pixelwise_loss`` is not read."""
        err = (out.xyz - target[..., :3]).abs()
        return torch.where(valid_depth[:, None] == 1, err.sum(-1), err[..., :2].sum(-1))

    def masked_loss(self, out: IntegralOutput, target, joint_mask, valid_depth,
                    distributed=False, group=None, pixelwise_loss=None):
        """The mean of ``joint_losses`` over the joints ``joint_mask`` keeps
        (the denominator clipped at 1); over the global batch of ``group``'s
        processes with ``distributed`` (``ops/dsnt.average_loss``)."""
        return average_loss(self.joint_losses(out, target, valid_depth), joint_mask,
                            distributed=distributed, group=group)
