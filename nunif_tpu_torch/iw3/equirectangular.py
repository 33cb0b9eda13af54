"""VR180 equirectangular projection, NHWC (counterpart of
``nunif_tpu/iw3/equirectangular.py``): each eye is zero-padded to a square
of 1.5 x its longest edge, then sampled bicubically through the
tan(azimuth) / tan(elevation) mapping.  The grid is built on the eye's
device with fp32 ``linspace`` / ``tan`` as in the JAX package; at 1080p an
eye becomes 2880 x 2880."""
from __future__ import annotations

import math

import torch

from ..modules.grid_sample import grid_sample
from ..modules.pad import zero_pad2d


def equirectangular_projection(c):
    """c (B, H, W, C) -> (B, S, S, C), S = max_edge + max_edge // 2 (one
    less on an axis whose pad is odd)."""
    B, h, w, _ = c.shape
    max_edge = max(h, w)
    output_size = max_edge + max_edge // 2
    pad_w = (output_size - w) // 2
    pad_h = (output_size - h) // 2
    c = zero_pad2d(c, (pad_w, pad_w, pad_h, pad_h))
    H, W = c.shape[1:3]
    y = torch.linspace(-1, 1, H, dtype=torch.float32, device=c.device)
    x = torch.linspace(-1, 1, W, dtype=torch.float32, device=c.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    azimuth = xx * (math.pi * 0.5)
    elevation = yy * (math.pi * 0.5)
    k = max_edge / output_size
    grid = torch.stack([k * torch.tan(azimuth),
                        k * (torch.tan(elevation) / torch.cos(azimuth))], dim=-1)
    z = grid_sample(c, grid[None].expand(B, H, W, 2), mode="bicubic",
                    padding_mode="zeros", align_corners=True)
    return z.clamp(0.0, 1.0)
