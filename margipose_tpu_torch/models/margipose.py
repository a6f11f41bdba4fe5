"""MargiPose: multi-stage CNN predicting per-joint xy/zy/xz marginal heatmaps.

NCHW counterpart of ``margipose_tpu/models/margipose.py`` (reference:
src/margipose/models/margipose_model.py:13-284). Each plane has its own
column module, as in the reference, where the JAX package stacks the three
with ``nn.vmap``; the state_dict keys are the reference's. The loss head goes
through ``ops.dsnt_jsd.dsnt_jsd_grouped``: each plane's heatmaps are already
``[B, J, H, W]``, the layout the kernel takes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from margipose_tpu_torch.models.inception import inception_in_cnn
from margipose_tpu_torch.models.layers import ResidualBlock, init_parameters
from margipose_tpu_torch.models.resnet import RESNET_LAYERS, ResNetStem
from margipose_tpu_torch.ops.dsnt import average_loss, dsnt, euclidean_losses, flat_softmax
from margipose_tpu_torch.ops.dsnt_jsd import dsnt_jsd_grouped

Default_MargiPose_Desc = {
    'type': 'margipose',
    'version': '6.0.1',
    'settings': {
        'n_stages': 4,
        'axis_permutation': True,
        'feature_extractor': 'inceptionv4',
        'pixelwise_loss': 'jsd',
    },
}

PLANES = ('xy', 'zy', 'xz')


class ModelOutput(NamedTuple):
    """Per-stage normalized heatmaps, each ``[B, J, H, W]`` float32."""

    xy_heatmaps: tuple
    zy_heatmaps: tuple
    xz_heatmaps: tuple


def permute_axis(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The marginal-heatmap axis permutation in NCHW.

    Channels split into groups of ``size`` (the spatial side); within each
    group the channel axis swaps with width ('zy') or height ('xz'). Same
    group/channel order as ``permute_axis_nhwc`` in the JAX package
    (reference: src/margipose/models/margipose_model.py:84-100).
    """
    if mode == 'xy':
        return x
    b, c, h, w = x.shape
    size = w
    assert h == w, 'axis permutation requires square feature maps'
    assert c % size == 0, 'channel count must divide spatial size'
    x5 = x.reshape(b, c // size, size, h, w)
    if mode == 'zy':  # channel-in-group <-> width
        x5 = x5.permute(0, 1, 4, 3, 2)
    elif mode == 'xz':  # channel-in-group <-> height
        x5 = x5.permute(0, 1, 3, 2, 4)
    else:
        raise ValueError(mode)
    return x5.reshape(b, c, h, w)


class HeatmapColumn(nn.Module):
    """Hourglass column 128->192(/2)->128 with the axis-permuting middle
    (reference: src/margipose/models/margipose_model.py:43-100)."""

    def __init__(self, n_joints: int, heatmap_space: str):
        super().__init__()
        self.heatmap_space = heatmap_space
        self.down_layers = nn.Sequential(
            ResidualBlock(128, 128), ResidualBlock(128, 128), ResidualBlock(128, 192, 'down'),
            ResidualBlock(192, 192), ResidualBlock(192, 192),
        )
        self.up_layers = nn.Sequential(
            ResidualBlock(192, 192), ResidualBlock(192, 192), ResidualBlock(192, 128, 'up'),
            ResidualBlock(128, 128), ResidualBlock(128, n_joints),
        )

    def forward(self, x):
        mid = permute_axis(self.down_layers(x), self.heatmap_space)
        return self.up_layers(mid)


class HeatmapCombiner(nn.Module):
    """1x1 conv of the three planes' heatmaps (channels xy, zy, xz joints)
    to 128 features (reference: src/margipose/models/margipose_model.py:142-150)."""

    def __init__(self, n_joints: int):
        super().__init__()
        self.conv = nn.Conv2d(3 * n_joints, 128, 1, bias=False)

    def forward(self, xy, zy, xz):
        return self.conv(torch.cat([xy, zy, xz], 1))


class MargiPoseModelInner(nn.Module):
    """(reference: src/margipose/models/margipose_model.py:153-200)"""

    def __init__(self, n_joints: int, n_stages: int, axis_permutation: bool,
                 feature_extractor: str):
        super().__init__()
        self.n_stages = n_stages
        if feature_extractor == 'inceptionv4':
            self.in_cnn = inception_in_cnn()
        elif feature_extractor in RESNET_LAYERS:
            self.in_cnn = ResNetStem(feature_extractor)
        else:
            raise ValueError(
                'unsupported image feature extractor model name: ' + feature_extractor)
        spaces = PLANES if axis_permutation else ('xy', 'xy', 'xy')
        for plane, space in zip(PLANES, spaces):
            setattr(self, f'{plane}_hm_cnns', nn.ModuleList(
                HeatmapColumn(n_joints, space) for _ in range(n_stages)))
        self.hm_combiners = nn.ModuleList(
            HeatmapCombiner(n_joints) for _ in range(n_stages - 1))

    def forward(self, x) -> ModelOutput:
        inp = self.in_cnn(x)
        hms = {plane: [] for plane in PLANES}
        for t in range(self.n_stages):
            if t > 0:
                # accumulate into the running input (stage t sees features +
                # comb_0 + ... + comb_{t-1}), as the reference does
                inp = inp + self.hm_combiners[t - 1](*(hms[p][t - 1] for p in PLANES))
            for plane in PLANES:
                column = getattr(self, f'{plane}_hm_cnns')[t]
                # softmax in f32, whatever the compute type
                hms[plane].append(flat_softmax(column(inp).float()))
        return ModelOutput(*(tuple(hms[p]) for p in PLANES))


def heatmaps_to_coords(xy_hm, zy_hm, xz_hm) -> torch.Tensor:
    """[B, J, H, W] heatmaps -> [B, J, 3]; z is the mean of the two z
    marginals (reference: src/margipose/models/margipose_model.py:254-261)."""
    xy = dsnt(xy_hm)
    z = 0.5 * (dsnt(zy_hm)[..., 0:1] + dsnt(xz_hm)[..., 1:2])
    return torch.cat([xy, z], -1)


class MargiPoseModel(nn.Module):
    """(reference: src/margipose/models/margipose_model.py:203-267)"""

    def __init__(self, n_joints=17, n_stages=4, axis_permutation=True,
                 feature_extractor='inceptionv4', pixelwise_loss='jsd', generator=None):
        super().__init__()
        self.pixelwise_loss = pixelwise_loss
        self.inner = MargiPoseModelInner(n_joints, n_stages, axis_permutation,
                                         feature_extractor)
        init_parameters(self, generator)

    def forward(self, x):
        out = self.inner(x)
        xyz = heatmaps_to_coords(out.xy_heatmaps[-1], out.zy_heatmaps[-1],
                                 out.xz_heatmaps[-1])
        return xyz, out


def _stage_components(out: ModelOutput, target_xyz, pixelwise_loss, sigma=1.0):
    """Per-stage (px_xy, px_zy, px_xz, coords_xy, coords_xyz): the pixelwise
    losses and coordinates of each plane, computed once and shared by the 2D
    and 3D losses. With the JSD loss every stage's three planes go through
    one ``dsnt_jsd_grouped`` call: one kernel launch a batch on the card."""
    stages = list(zip(out.xy_heatmaps, out.zy_heatmaps, out.xz_heatmaps))
    if pixelwise_loss == 'jsd':
        x, y, z = target_xyz.unbind(-1)
        targets = [torch.stack(pair, -1).contiguous() for pair in ((x, y), (z, y), (x, z))]
        heads = dsnt_jsd_grouped([hm for stage in stages for hm in stage],
                                 targets * len(stages), sigma)
    elif pixelwise_loss is not None:
        raise ValueError(f'unrecognised pixelwise loss: {pixelwise_loss}')
    for t, stage in enumerate(stages):
        if pixelwise_loss == 'jsd':
            (cxy, pxy), (czy, pzy), (cxz, pxz) = heads[3 * t:3 * t + 3]
        else:
            cxy, czy, cxz = (dsnt(hm) for hm in stage)
            pxy = pzy = pxz = 0.0
        xyz = torch.cat([cxy, 0.5 * (czy[..., 0:1] + cxz[..., 1:2])], -1)
        yield pxy, pzy, pxz, cxy, xyz


def margipose_joint_losses(out: ModelOutput, target, valid_depth, pixelwise_loss='jsd'):
    """Per-joint losses [B, J]: the 3D loss for rows with ``valid_depth`` 1,
    the 2D loss for the others (reference: src/margipose/bin/train_3d.py:126-142)."""
    target_xyz = target[..., :3]
    losses_3d = losses_2d = 0.0
    for pxy, pzy, pxz, cxy, xyz in _stage_components(out, target_xyz, pixelwise_loss):
        losses_3d = losses_3d + pxy + pzy + pxz + euclidean_losses(xyz, target_xyz)
        losses_2d = losses_2d + pxy + euclidean_losses(cxy, target_xyz[..., :2])
    return torch.where(valid_depth[:, None] == 1, losses_3d, losses_2d)


def margipose_masked_loss(out: ModelOutput, target, joint_mask, valid_depth,
                          pixelwise_loss='jsd', distributed=False, group=None):
    """``margipose_joint_losses``' masked mean over joints; over the global
    batch of ``group``'s processes with ``distributed``
    (``ops/dsnt.average_loss``)."""
    return average_loss(margipose_joint_losses(out, target, valid_depth, pixelwise_loss),
                        joint_mask, distributed=distributed, group=group)
