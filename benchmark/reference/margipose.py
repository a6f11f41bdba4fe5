"""The plain reference MargiPose, float32 PyTorch: a frozen copy of the
port's test twin (``tests/torch_twin.py``), built from the published
architecture spec, with the reference state_dict keys.

It reproduces what the reference constructs:

  * the truncated InceptionV4 stem: pretrainedmodels feature blocks 0-6
    with every Conv2d/MaxPool2d padding forced to kernel_size // 2, plus a
    1x1 conv to 128 channels + BN + ReLU
    (reference: src/margipose/models/margipose_model.py:103-118);
  * HeatmapColumn hourglasses with the axis-permuting middle
    (reference: src/margipose/models/margipose_model.py:43-100);
  * HeatmapCombiner + the multi-stage feedback loop
    (reference: src/margipose/models/margipose_model.py:142-200);
  * dsnt / flat_softmax coordinate heads with half-pixel-centre linspace
    (reference: src/margipose/dsntnn.py:12-96).

Departures from the twin: the DSNT grid is made on the heatmaps' device
(the twin makes it on the CPU), and the twin's test helpers are left out.
Nothing here imports the port or the JAX package.
"""

import torch
from torch import nn

# ---- dsntnn numeric contract (torch side) --------------------------------


def t_normalized_linspace(length, dtype=torch.float32, device=None):
    """Half-pixel-centre coords in (-1, 1) (reference: src/margipose/dsntnn.py:12-36)."""
    first = -(length - 1.0) / length
    return torch.arange(length, dtype=dtype, device=device) * (2.0 / length) + first


def t_flat_softmax(x):
    b, c = x.shape[:2]
    flat = x.reshape(b, c, -1).softmax(-1)
    return flat.reshape(x.shape)


def t_dsnt(hm):
    """[B, C, H, W] normalized heatmaps -> [B, C, 2] (x, y) expectations."""
    h, w = hm.shape[-2:]
    cx = t_normalized_linspace(w, hm.dtype, hm.device)
    cy = t_normalized_linspace(h, hm.dtype, hm.device)
    ex = (hm * cx.view(1, 1, 1, w)).sum((-2, -1))
    ey = (hm * cy.view(1, 1, h, 1)).sum((-2, -1))
    return torch.stack([ex, ey], -1)


def t_heatmaps_to_coords(xy_hm, zy_hm, xz_hm):
    """(reference: src/margipose/models/margipose_model.py:254-261)"""
    xy = t_dsnt(xy_hm)
    zy = t_dsnt(zy_hm)
    xz = t_dsnt(xz_hm)
    z = 0.5 * (zy[:, :, 0:1] + xz[:, :, 1:2])
    return torch.cat([xy, z], -1)


def t_spread(xy_hm, zy_hm, xz_hm):
    """[B, C, 3]: the standard deviation of the heatmaps' x, y and z
    estimates, sqrt(E[(X - E[X])^2]) over each marginal; z's from its two
    planes, as z is their mean (not in the twin)."""

    def var(hm):
        h, w = hm.shape[-2:]
        cx = t_normalized_linspace(w, hm.dtype, hm.device).view(1, 1, 1, w)
        cy = t_normalized_linspace(h, hm.dtype, hm.device).view(1, 1, h, 1)
        mx, my = (hm * cx).sum((-2, -1), keepdim=True), (hm * cy).sum((-2, -1), keepdim=True)
        return (hm * (cx - mx) ** 2).sum((-2, -1)), (hm * (cy - my) ** 2).sum((-2, -1))

    vx, vy = var(xy_hm)
    vz = 0.25 * (var(zy_hm)[0] + var(xz_hm)[1])
    return torch.stack([vx, vy, vz], -1).sqrt()


# ---- InceptionV4 stem twin (pretrainedmodels naming, post-surgery padding)


class TBasicConv2d(nn.Module):
    """pretrainedmodels BasicConv2d: conv(bias=False) + BN(eps=1e-3) + ReLU."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class TMixed3a(nn.Module):
    def __init__(self):
        super().__init__()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.conv = TBasicConv2d(64, 96, 3, stride=2, padding=1)

    def forward(self, x):
        return torch.cat([self.maxpool(x), self.conv(x)], 1)


class TMixed4a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(
            TBasicConv2d(160, 64, 1),
            TBasicConv2d(64, 96, 3, padding=1),
        )
        self.branch1 = nn.Sequential(
            TBasicConv2d(160, 64, 1),
            TBasicConv2d(64, 64, (1, 7), padding=(0, 3)),
            TBasicConv2d(64, 64, (7, 1), padding=(3, 0)),
            TBasicConv2d(64, 96, 3, padding=1),
        )

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], 1)


class TMixed5a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = TBasicConv2d(192, 192, 3, stride=2, padding=1)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return torch.cat([self.conv(x), self.maxpool(x)], 1)


class TInceptionA(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = TBasicConv2d(384, 96, 1)
        self.branch1 = nn.Sequential(
            TBasicConv2d(384, 64, 1),
            TBasicConv2d(64, 96, 3, padding=1),
        )
        self.branch2 = nn.Sequential(
            TBasicConv2d(384, 64, 1),
            TBasicConv2d(64, 96, 3, padding=1),
            TBasicConv2d(96, 96, 3, padding=1),
        )
        self.branch3 = nn.Sequential(
            nn.AvgPool2d(3, stride=1, padding=1, count_include_pad=False),
            TBasicConv2d(384, 96, 1),
        )

    def forward(self, x):
        return torch.cat(
            [self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


def t_inception_feature_blocks():
    """The 7 truncated-InceptionV4 feature blocks, post padding surgery."""
    return [
        TBasicConv2d(3, 32, 3, stride=2, padding=1),
        TBasicConv2d(32, 32, 3, padding=1),
        TBasicConv2d(32, 64, 3, padding=1),
        TMixed3a(),
        TMixed4a(),
        TMixed5a(),
        TInceptionA(),
    ]


def t_inception_in_cnn():
    """The full margipose inceptionv4 feature extractor
    (reference: src/margipose/models/margipose_model.py:104-118)."""
    return nn.Sequential(
        *t_inception_feature_blocks(),
        nn.Conv2d(384, 128, 1),
        nn.BatchNorm2d(128),
        nn.ReLU(inplace=True),
    )


# ---- Column / combiner / full-model twins ---------------------------------


def _t_res_block(in_ch, out_ch, kind):
    """Residual block with the reference Sequential layout (module.0/1/3/4 +
    shortcut.0/1; reference: src/margipose/models/margipose_model.py:25-40)."""
    if kind == 'regular':
        conv_in = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        sc_in = nn.Conv2d(in_ch, out_ch, 1, bias=False)
    elif kind == 'down':
        conv_in = nn.Conv2d(in_ch, out_ch, 3, padding=1, stride=2, bias=False)
        sc_in = nn.Conv2d(in_ch, out_ch, 1, stride=2, bias=False)
    elif kind == 'up':
        conv_in = nn.ConvTranspose2d(in_ch, out_ch, 3, padding=1, stride=2,
                                     output_padding=1, bias=False)
        sc_in = nn.ConvTranspose2d(in_ch, out_ch, 1, stride=2, output_padding=1,
                                   bias=False)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.module = nn.Sequential(
                conv_in, nn.BatchNorm2d(out_ch), nn.ReLU(),
                nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
                nn.BatchNorm2d(out_ch), nn.ReLU(),
            )
            self.shortcut = nn.Sequential(sc_in, nn.BatchNorm2d(out_ch))

        def forward(self, x):
            return self.module(x) + self.shortcut(x)

    return Block()


class TColumn(nn.Module):
    """(reference: src/margipose/models/margipose_model.py:43-100)"""

    def __init__(self, n_joints, space):
        super().__init__()
        self.space = space
        self.down_layers = nn.Sequential(
            _t_res_block(128, 128, 'regular'),
            _t_res_block(128, 128, 'regular'),
            _t_res_block(128, 192, 'down'),
            _t_res_block(192, 192, 'regular'),
            _t_res_block(192, 192, 'regular'),
        )
        self.up_layers = nn.Sequential(
            _t_res_block(192, 192, 'regular'),
            _t_res_block(192, 192, 'regular'),
            _t_res_block(192, 128, 'up'),
            _t_res_block(128, 128, 'regular'),
            _t_res_block(128, n_joints, 'regular'),
        )

    def forward(self, x):
        mid = self.down_layers(x)
        size = mid.shape[-1]
        if self.space == 'zy':
            mid = torch.cat([t.permute(0, 3, 2, 1) for t in mid.split(size, -3)], -3)
        elif self.space == 'xz':
            mid = torch.cat([t.permute(0, 2, 1, 3) for t in mid.split(size, -3)], -3)
        return self.up_layers(mid)


class TCombiner(nn.Module):
    """(reference: src/margipose/models/margipose_model.py:142-150)"""

    def __init__(self, n_joints):
        super().__init__()
        self.conv = nn.Conv2d(n_joints * 3, 128, 1, bias=False)

    def forward(self, xy, zy, xz):
        return self.conv(torch.cat([xy, zy, xz], -3))


class TMargiPoseInner(nn.Module):
    """(reference: src/margipose/models/margipose_model.py:153-200)"""

    def __init__(self, n_joints, n_stages, axis_permutation=True):
        super().__init__()
        self.n_stages = n_stages
        self.in_cnn = t_inception_in_cnn()
        self.xy_hm_cnns = nn.ModuleList()
        self.zy_hm_cnns = nn.ModuleList()
        self.xz_hm_cnns = nn.ModuleList()
        self.hm_combiners = nn.ModuleList()
        zy, xz = ('zy', 'xz') if axis_permutation else ('xy', 'xy')
        for t in range(n_stages):
            if t > 0:
                self.hm_combiners.append(TCombiner(n_joints))
            self.xy_hm_cnns.append(TColumn(n_joints, 'xy'))
            self.zy_hm_cnns.append(TColumn(n_joints, zy))
            self.xz_hm_cnns.append(TColumn(n_joints, xz))

    def forward(self, x):
        features = self.in_cnn(x)
        xy_hms, zy_hms, xz_hms = [], [], []
        inp = features
        for t in range(self.n_stages):
            if t > 0:
                # accumulating, like the reference's `inp = inp + combined`
                # (src/margipose/models/margipose_model.py:195) — distinct
                # from `features + combined` only for n_stages >= 3
                inp = inp + self.hm_combiners[t - 1](
                    xy_hms[t - 1], zy_hms[t - 1], xz_hms[t - 1])
            xy_hms.append(t_flat_softmax(self.xy_hm_cnns[t](inp)))
            zy_hms.append(t_flat_softmax(self.zy_hm_cnns[t](inp)))
            xz_hms.append(t_flat_softmax(self.xz_hm_cnns[t](inp)))
        return xy_hms, zy_hms, xz_hms


class TMargiPose(nn.Module):
    """(reference: src/margipose/models/margipose_model.py:203-267)"""

    def __init__(self, n_joints=17, n_stages=2, axis_permutation=True):
        super().__init__()
        self.inner = TMargiPoseInner(n_joints, n_stages, axis_permutation)

    def forward(self, x):
        xy_hms, zy_hms, xz_hms = self.inner(x)
        xyz = t_heatmaps_to_coords(xy_hms[-1], zy_hms[-1], xz_hms[-1])
        return xyz, (xy_hms, zy_hms, xz_hms)
