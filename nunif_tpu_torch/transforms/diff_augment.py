"""Differentiable pair augmentations for GAN training (counterpart of
``nunif_tpu/transforms/diff_augment.py``).

The same random translate, rotate or downsample is applied to (input,
target), so the discriminator cannot tell the augmentation apart.  Where
the JAX functions take a PRNG key, these take a ``torch.Generator`` (the
two give different draws from one seed; ``diff_translate`` and ``rotate``
take the shifts and angles themselves).
"""
from __future__ import annotations

import math

import torch

from ..modules.grid_sample import grid_sample
from ..modules.resize import resize


def diff_translate(x, x_shift, y_shift):
    """Integer-pixel shift of each image by (x_shift[b], y_shift[b]) with
    zero fill; differentiable with respect to x."""
    B, H, W, _C = x.shape
    dev = x.device
    x_shift = torch.as_tensor(x_shift, device=dev)
    y_shift = torch.as_tensor(y_shift, device=dev)
    ix = torch.arange(W, device=dev)[None, None, :] - x_shift[:, None, None]
    iy = torch.arange(H, device=dev)[None, :, None] - y_shift[:, None, None]
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    ix = ix.clamp(0, W - 1)
    iy = iy.clamp(0, H - 1)
    bidx = torch.arange(B, device=dev)[:, None, None]
    return x[bidx, iy, ix, :] * valid[..., None].to(x.dtype)


def diff_pair_random_translate(generator, x, y, ratio=0.15):
    """The same random shift, up to ``ratio`` of each side, on both."""
    B, H, W, _ = x.shape
    max_x, max_y = int(W * ratio), int(H * ratio)
    dev = generator.device
    dx = torch.randint(-max_x, max_x + 1, (B,), generator=generator, device=dev)
    dy = torch.randint(-max_y, max_y + 1, (B,), generator=generator, device=dev)
    return diff_translate(x, dx, dy), diff_translate(y, dx, dy)


def rotate(x, angle_rad):
    """Rotate each image by angle_rad[b] about its centre: bilinear, zero
    padding, align_corners=False."""
    B, H, W, _C = x.shape
    dev = x.device
    angle = torch.as_tensor(angle_rad, dtype=torch.float32, device=dev)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    gx = cos * (xx[None] - cx) - sin * (yy[None] - cy) + cx
    gy = sin * (xx[None] - cx) + cos * (yy[None] - cy) + cy
    grid = torch.stack([(gx + 0.5) * 2.0 / W - 1.0,
                        (gy + 0.5) * 2.0 / H - 1.0], dim=-1)
    return grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                       align_corners=False)


def diff_pair_random_rotate(generator, x, y, angle=45):
    """The same random rotation in [-angle, angle) degrees on both."""
    a = torch.rand((x.shape[0],), generator=generator, device=generator.device)
    a = (a * (2 * angle) - angle) * (math.pi / 180.0)
    return rotate(x, a), rotate(y, a)


def diff_pair_random_downsample(generator, x, y, scale_factor_min=0.5,
                                scale_factor_max=1.0, steps=4):
    """Both downsampled (antialiased bilinear) by one of ``steps`` scales in
    [min, max] and resized back (bilinear) to their size."""
    H, W = x.shape[1:3]
    i = int(torch.randint(0, steps, (), generator=generator,
                          device=generator.device))
    s = scale_factor_min + (scale_factor_max - scale_factor_min) * i / (steps - 1)
    h, w = max(2, int(H * s)), max(2, int(W * s))

    def down_up(t):
        t = resize(t, h, w, mode="bilinear", antialias=True)
        return resize(t, H, W, mode="bilinear", antialias=False)
    return down_up(x), down_up(y)
