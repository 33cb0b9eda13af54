"""Local standard-deviation gradient mask (counterpart of
``nunif_tpu/modules/local_std_mask.py``).

The per-pixel std over a k x k reflection-padded window (correction 0),
as sqrt(E[x^2] - E[x]^2) from two box filters, averaged over the
channels and clamped to a weight in [min_weight, 1]; ``local_std_mask``
blends x with its detached copy by that weight, so flat regions pass
less gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .pad import reflection_pad2d


@torch.no_grad()
def compute_local_std_mask(y, kernel_size=15, max_std=0.1, min_weight=0.1):
    y = y.float()
    p = (kernel_size - 1) // 2
    yp = reflection_pad2d(y, (p, p, p, p)).permute(0, 3, 1, 2)
    m1 = F.avg_pool2d(yp, kernel_size, stride=1)
    m2 = F.avg_pool2d(yp * yp, kernel_size, stride=1)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    std = torch.sqrt(var).mean(dim=1, keepdim=True).permute(0, 2, 3, 1)
    return torch.clamp(torch.clamp(std, max=max_std) / max_std, min=min_weight)


def local_std_mask(x, y, kernel_size=15, max_std=0.1, min_weight=0.1):
    if x.shape != y.shape:
        raise ValueError(f"local_std_mask: {tuple(x.shape)} != {tuple(y.shape)}")
    w = compute_local_std_mask(y, kernel_size=kernel_size, max_std=max_std,
                               min_weight=min_weight).to(x.dtype)
    return x * w + x.detach() * (1 - w)
