"""The model input from uint8 pixels: ImageNet normalisation, NCHW float32
(reference: src/margipose/data_specs.py:26-64)."""

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STDDEV = (0.229, 0.224, 0.225)


def normalise(pixels):
    """uint8 [B, H, W, 3] (a tensor) -> float32 [B, 3, H, W]."""
    mean = torch.tensor(IMAGENET_MEAN, device=pixels.device)
    std = torch.tensor(IMAGENET_STDDEV, device=pixels.device)
    return ((pixels.float() / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()
