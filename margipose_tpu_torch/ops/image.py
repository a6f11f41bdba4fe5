"""Batched image transforms on the device: plain tensor ops on NHWC batches.

Counterpart of ``margipose_tpu/ops/image.py`` (XLA there, no Pallas, so no
hand-written kernel here). The host pipeline
(``geometry/transforms.py``) composes the whole geometric augmentation into
one affine per example; this module applies that affine, colour jitter and
ImageNet normalisation to a batch on whatever device it lies on.

Conventions match the host path and the JAX module:
  * affines map input to output pixels (``out = A @ in``), the matrices
    ``geometry.transforms.build_affine`` makes; the inverse is taken here;
  * bilinear sampling with zero fill outside the source (PIL AFFINE), at
    ``A^-1 @ (x + 0.5, y + 0.5) - 0.5``: integer coordinates are pixel
    corners, as in PIL;
  * colour jitter in PIL ImageEnhance order brightness -> contrast ->
    saturation -> hue with ITU-R 601-2 luma weights.
"""

from __future__ import annotations

import torch

# ITU-R 601-2 luma transform (PIL's "L" conversion weights)
_LUMA = (299.0 / 1000.0, 587.0 / 1000.0, 114.0 / 1000.0)


def affine_warp(images: torch.Tensor, affines: torch.Tensor, out_height: int,
                out_width: int) -> torch.Tensor:
    """Batched inverse-affine bilinear warp.

    Args:
      images: [B, H, W, C] float tensor.
      affines: [B, 3, 3] (or [B, 2, 3]) output<-input pixel affines.
      out_height, out_width: output size.

    Returns:
      [B, out_height, out_width, C]; points sampling outside the source are 0.
    """
    b, h, w, c = images.shape
    affines = affines.to(device=images.device, dtype=torch.float32)
    if affines.shape[-2:] == (2, 3):
        bottom = affines.new_tensor([0.0, 0.0, 1.0]).expand(affines.shape[0], 1, 3)
        affines = torch.cat([affines, bottom], dim=-2)
    inv = torch.linalg.inv(affines)  # input <- output

    ys = torch.arange(out_height, dtype=torch.float32, device=images.device) + 0.5
    xs = torch.arange(out_width, dtype=torch.float32, device=images.device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')  # [oh, ow]
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    # written out, not a matmul: TF32 or autocast must not touch the geometry
    sx = inv[:, 0, 0:1] * gx + inv[:, 0, 1:2] * gy + inv[:, 0, 2:3] - 0.5  # [B, oh*ow]
    sy = inv[:, 1, 0:1] * gx + inv[:, 1, 1:2] * gy + inv[:, 1, 2:3] - 0.5

    x0 = torch.floor(sx)  # floor, not truncation: negative coordinates
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None].to(images.dtype)
    fy = (sy - y0)[..., None].to(images.dtype)
    x0i = x0.to(torch.int64)  # gather takes int64 indices
    y0i = y0.to(torch.int64)
    flat = images.reshape(b, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [B, oh*ow]
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * valid[..., None].to(images.dtype)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return out.reshape(b, out_height, out_width, c)


def _grayscale(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] -> [B,H,W,1] ITU-R 601-2 luma."""
    luma = images.new_tensor(_LUMA)
    return (images * luma).sum(-1, keepdim=True)


def adjust_colour(images: torch.Tensor, brightness, contrast, saturation,
                  hue) -> torch.Tensor:
    """Batched colour jitter on [B,H,W,3] images in [0, 1].

    Per-example factors (shape [B] or scalars), in PIL ImageEnhance order:
    brightness -> contrast (blend with the mean luma) -> saturation (blend
    with the per-pixel luma) -> hue (a rotation in HSV)."""
    b = images.shape[0]

    def per_ex(v):
        v = torch.as_tensor(v, dtype=images.dtype, device=images.device)
        return v.expand(b).reshape(b, 1, 1, 1)

    brightness, contrast = per_ex(brightness), per_ex(contrast)
    saturation, hue = per_ex(saturation), per_ex(hue)

    # clamp after brightness, as the host paths round to uint8 after each
    # enhance, so the contrast mean sees the same inputs for brightness > 1
    x = (images * brightness).clamp(0.0, 1.0)
    gray = _grayscale(x)
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)
    x = mean + (x - mean) * contrast
    gray = _grayscale(x)
    x = gray + (x - gray) * saturation
    x = x.clamp(0.0, 1.0)

    hsv = rgb_to_hsv(x)
    shifted = hsv_to_rgb(torch.cat([torch.remainder(hsv[..., 0:1] + hue, 1.0), hsv[..., 1:]],
                                   dim=-1))
    return torch.where(hue.abs() > 1e-8, shifted, x)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0,1] -> HSV in [0,1]."""
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    span = maxc - minc
    s = torch.where(maxc > 0, span / maxc.clamp(min=1e-12), torch.zeros_like(maxc))
    safe = span.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(span == 0, torch.zeros_like(h), h)
    return torch.stack([h, s, v], dim=-1)


# the (r, g, b) source of each sextant i of the hue circle: 0 = v, 1 = q,
# 2 = p, 3 = t (colorsys.hsv_to_rgb)
_SEXTANTS = ((0, 3, 2), (1, 0, 2), (2, 0, 3), (2, 1, 0), (3, 2, 0), (0, 2, 1))


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """[..., 3] HSV in [0,1] -> RGB in [0,1]."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i, 6.0).to(torch.int64)
    choices = torch.stack([v, q, p, t], dim=-1)  # [..., 4]
    table = torch.tensor(_SEXTANTS, device=hsv.device)  # [6, 3]
    return torch.gather(choices, -1, table[i])


def normalize_imagenet(images: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std over the channel axis of [B,H,W,3] images in [0,1]."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def device_augment(images: torch.Tensor, affines: torch.Tensor, out_height: int,
                   out_width: int, brightness, contrast, saturation, hue,
                   mean, std) -> torch.Tensor:
    """Warp, colour jitter and normalise: raw [B,H,W,3] in [0,1] -> the
    normalised [B,out_h,out_w,3] model input."""
    x = affine_warp(images, affines, out_height, out_width)
    x = adjust_colour(x, brightness, contrast, saturation, hue)
    return normalize_imagenet(x, mean, std)
