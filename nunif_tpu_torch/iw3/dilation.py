"""Depth-edge dilation and the inpaint masks' morphology, NHWC
(counterpart of ``nunif_tpu/iw3/dilation.py``)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..modules.pad import replication_pad2d
from ..modules.pool import max_pool2d, min_pool2d

_GAUSS_KERNEL = ((21, 31, 21), (31, 48, 31), (21, 31, 21))


@functools.lru_cache(maxsize=8)
def _gauss_kernel(device):
    return (torch.tensor(_GAUSS_KERNEL, dtype=torch.float32) / 256.0).to(device)


def edge_dilation_parse(edge_dilation):
    if isinstance(edge_dilation, (list, tuple)):
        if len(edge_dilation) == 0:
            x = y = 0
        elif len(edge_dilation) == 1:
            x = y = edge_dilation[0]
        else:
            x, y = edge_dilation[0], edge_dilation[1]
    elif isinstance(edge_dilation, int):
        x = y = edge_dilation
    elif edge_dilation is None:
        x = y = 0
    else:
        raise ValueError(f"Unsupported edge_dilation type {type(edge_dilation)}")
    return x, y


def edge_dilation_is_enabled(edge_dilation) -> bool:
    x, y = edge_dilation_parse(edge_dilation)
    return x != 0 or y != 0


def gaussian_blur(x):
    """Fixed 3x3 gaussian with replicate padding, per channel."""
    C = x.shape[-1]
    xp = replication_pad2d(x.float(), (1, 1, 1, 1)).permute(0, 3, 1, 2)
    k = _gauss_kernel(x.device).reshape(1, 1, 3, 3).expand(C, 1, 3, 3)
    return F.conv2d(xp, k, groups=C).permute(0, 2, 3, 1).to(x.dtype)


def dilate(mask, kernel_size=3):
    return max_pool2d(mask, kernel_size)


def erode(mask, kernel_size=3):
    return min_pool2d(mask, kernel_size)


def closing(mask, kernel_size=3, n_iter=2):
    mask = mask.float()
    for _ in range(n_iter):
        mask = dilate(mask, kernel_size)
    for _ in range(n_iter):
        mask = erode(mask, kernel_size)
    return mask


def mask_closing(mask, kernel_size=3, n_iter=2):
    """Closing that puts back the isolated pixels it erased, clipped to
    [0, 1]."""
    mask_org = mask.float()
    m = closing(mask_org, kernel_size=kernel_size, n_iter=n_iter)
    return (m + mask_org).clamp(0.0, 1.0)


def _dilate_x(mask, n_iter: int, direction: int):
    """Grow a mask horizontally by n_iter pixels: a one-sided max over
    n_iter + 1 columns, zero-padded.  direction +1 grows rightward (pads
    left), -1 leftward."""
    if n_iter <= 0:
        return mask
    pads = (n_iter, 0) if direction > 0 else (0, n_iter)
    m = F.pad(mask.float().permute(0, 3, 1, 2), pads)
    out = F.max_pool2d(m, (1, n_iter + 1), stride=1)
    return out.permute(0, 2, 3, 1).to(mask.dtype)


def _scaled_iter(mask, n_iter, base_width):
    """n_iter counted at ``base_width``, rescaled to the mask's width
    (Python's round: half to even), at least 1."""
    if base_width is None:
        return n_iter
    return max(round(mask.shape[-2] / base_width * n_iter), 1)


def dilate_outer(mask, n_iter, base_width=None):
    """mask | mask shifted right, n_iter times."""
    if n_iter <= 0:
        return mask
    return _dilate_x(mask, _scaled_iter(mask, n_iter, base_width), +1)


def dilate_inner(mask, n_iter, base_width=None):
    """mask | mask shifted left, n_iter times."""
    if n_iter <= 0:
        return mask
    return _dilate_x(mask, _scaled_iter(mask, n_iter, base_width), -1)


def edge_weight(x):
    """Per-frame z-score of the 3x3 local range, clipped to +-3 and
    rescaled to [0, 1]."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    x32 = x.float()
    range_v = max_pool2d(x32, 3) - min_pool2d(x32, 3)
    mean = range_v.mean(dim=(1, 2, 3), keepdim=True)
    range_c = range_v - mean
    range_s = (range_c ** 2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
    w = (range_c / (range_s + 1e-6)).clamp(-3, 3)
    w_min = w.amin(dim=(1, 2, 3), keepdim=True)
    w_max = w.amax(dim=(1, 2, 3), keepdim=True)
    return (w - w_min) / ((w_max - w_min) + 1e-6)


def dilate_edge(x, n):
    """Edge-weighted blurred dilation of a depth map; n: int or
    (x_iter, y_iter)."""
    x_iter, y_iter = edge_dilation_parse(n)
    xy_iter = min(x_iter, y_iter)
    x_iter -= xy_iter
    y_iter -= xy_iter

    def step(x, kernel):
        w = edge_weight(x)
        x2 = dilate(gaussian_blur(x), kernel)
        return x * (1 - w) + x2 * w

    for _ in range(xy_iter):
        x = step(x, (3, 3))
    for _ in range(y_iter):
        x = step(x, (3, 1))
    for _ in range(x_iter):
        x = step(x, (1, 3))
    return x
