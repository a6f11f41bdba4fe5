"""Seeding, cuDNN algorithm flags, skeleton drawing.

Counterpart of ``margipose_tpu/utils.py:15-54`` (reference:
src/margipose/utils.py:12-38,198-215).
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
