"""The DSNT/JSD masked loss, in plain float32 PyTorch.

What the reference trains and scores (reference:
src/margipose/bin/train_3d.py:126-142, src/margipose/dsntnn.py:99-232):
for every stage and plane, the Jensen-Shannon divergence between the
normalised heatmap and a Gaussian of sigma 1 px at the target, plus the
Euclidean distance of the stage's coordinates (xy from the xy plane, z the
mean of the zy and xz planes' z). A 3D row (``valid_depth`` 1) sums all
three planes' divergences and the 3D distance; a 2D row the xy plane's and
the 2D distance. The loss is the mean over the joints that ``mask`` keeps
(its denominator clipped at 1).
"""

import torch

from benchmark.reference.margipose import t_dsnt, t_normalized_linspace

EPS = 1e-24


def gaussian(mu, h, w, sigma=1.0):
    """Normalised separable Gaussians [B, J, H, W] at ``mu`` [B, J, 2] (x, y)."""
    xs = t_normalized_linspace(w, mu.dtype, mu.device)
    ys = t_normalized_linspace(h, mu.dtype, mu.device)
    kx = -0.5 * (w / (2.0 * sigma)) ** 2
    ky = -0.5 * (h / (2.0 * sigma)) ** 2
    gx = torch.exp(kx * (xs - mu[..., 0:1]) ** 2)[..., None, :]
    gy = torch.exp(ky * (ys - mu[..., 1:2]) ** 2)[..., :, None]
    g = gx * gy
    return g / (g.sum((-2, -1), keepdim=True) + EPS)


def kl(p, q):
    return (p * (torch.log(p + EPS) - torch.log(q + EPS))).sum((-2, -1))


def js(p, q):
    m = 0.5 * (p + q)
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def joint_losses(hms, target, valid_depth):
    """Per-joint losses [B, J] of the stages' heatmaps ``hms`` = ([xy], [zy],
    [xz]) against ``target`` [B, J, 3]."""
    x, y, z = target.detach().unbind(-1)
    mu_xy, mu_zy, mu_xz = (torch.stack(p, -1) for p in ((x, y), (z, y), (x, z)))
    total_3d = total_2d = 0.0
    for xy, zy, xz in zip(*hms):
        h, w = xy.shape[-2:]
        j_xy = js(xy, gaussian(mu_xy, h, w))
        j_zy = js(zy, gaussian(mu_zy, h, w))
        j_xz = js(xz, gaussian(mu_xz, h, w))
        c_xy, c_zy, c_xz = t_dsnt(xy), t_dsnt(zy), t_dsnt(xz)
        xyz = torch.cat([c_xy, 0.5 * (c_zy[..., 0:1] + c_xz[..., 1:2])], -1)
        total_3d = total_3d + j_xy + j_zy + j_xz + (xyz - target).pow(2).sum(-1).sqrt()
        total_2d = total_2d + j_xy + (c_xy - target[..., :2]).pow(2).sum(-1).sqrt()
    return torch.where(valid_depth[:, None] == 1, total_3d, total_2d)


def masked_loss(hms, target, mask, valid_depth):
    """The mean of ``joint_losses`` over the joints ``mask`` keeps."""
    losses = joint_losses(hms, target[..., :3], valid_depth)
    return (losses * mask).sum() / mask.sum().clamp(min=1.0)
