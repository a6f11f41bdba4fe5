"""Seeding, cuDNN algorithm flags, skeleton drawing.

Counterpart of ``margipose_tpu/utils.py:15-80`` (reference:
src/margipose/utils.py:12-38,124-170,198-215).
"""

from __future__ import annotations

import random

import numpy as np
import PIL.Image
import PIL.ImageDraw
import torch


def seed_all(seed: int):
    """Seed the host RNGs and torch's default generator (reference:
    src/margipose/utils.py:12-16). The port's own randomness (model init,
    test inputs) takes explicit ``torch.Generator``s besides."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def init_algorithms(deterministic: bool = False):
    """cuDNN's algorithm choice (reference: src/margipose/utils.py:19-24):
    deterministic algorithms when asked, else let cuDNN time its candidates
    and pick the fastest for each shape."""
    torch.backends.cudnn.benchmark = not deterministic
    torch.backends.cudnn.deterministic = deterministic


def joint_colour(joint_names, hflip_indices, j):
    """Left/right/centre joint colouring
    (reference: src/margipose/utils.py:27-38)."""
    if hflip_indices[j] == j:
        return (255, 215, 0)  # centre: gold
    if 'left' in joint_names[j]:
        return (255, 60, 60)  # left: red
    return (60, 60, 255)  # right: blue


def draw_skeleton_2d(img: PIL.Image.Image, skel2d, skel_desc, width=2):
    """Draw a 2D skeleton over a PIL image in place
    (reference: src/margipose/utils.py:198-215)."""
    draw = PIL.ImageDraw.Draw(img)
    skel2d = np.asarray(skel2d)
    for j, parent in enumerate(skel_desc.joint_tree):
        if j == parent:
            continue
        colour = joint_colour(skel_desc.joint_names, skel_desc.hflip_indices, j)
        draw.line(
            [tuple(skel2d[j][:2]), tuple(skel2d[parent][:2])],
            fill=colour, width=width,
        )
    return img


def plot_skeleton_on_axes3d(skel, skel_desc, ax, invert=True, alpha=1.0):
    """3D matplotlib skeleton plot (reference: src/margipose/utils.py:124-170).

    ``ax`` is a matplotlib 3D axes the caller made; this module imports no
    matplotlib, so nothing on the card's path needs it. ``alpha`` dims a
    skeleton so a prediction and a ground truth can share one axes."""
    skel = np.asarray(skel)
    for j, parent in enumerate(skel_desc.joint_tree):
        if j == parent:
            continue
        colour = np.asarray(joint_colour(skel_desc.joint_names, skel_desc.hflip_indices, j)) / 255.0
        xs = [skel[j, 0], skel[parent, 0]]
        ys = [skel[j, 1], skel[parent, 1]]
        zs = [skel[j, 2], skel[parent, 2]]
        # plot with z up-ish: (x, z, -y) so the person stands upright
        ax.plot(xs, zs, [-y for y in ys], color=tuple(colour), alpha=alpha)
    ax.set_xlabel('x')
    ax.set_ylabel('z')
    ax.set_zlabel('-y')
    if invert and hasattr(ax, 'invert_zaxis'):
        ax.invert_zaxis()
    return ax
