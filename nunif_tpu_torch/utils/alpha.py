"""Alpha-border padding (counterpart of ``nunif_tpu/utils/alpha.py``).

Transparent pixels take the mean RGB of their opaque 3x3 neighbours,
``offset`` rounds outward from the opaque region, so that a model's VALID
convs do not bleed the background colour into alpha edges.  fp32 on the
input's device; a 3x3 box sum is two separable pad-and-add passes.
"""
import torch
import torch.nn.functional as F


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum of (H, W, C) with zeros outside."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    s = xp[:-2] + xp[1:-1] + xp[2:]
    return s[:, :-2] + s[:, 1:-1] + s[:, 2:]


def alpha_border_pad(rgb: torch.Tensor, alpha: torch.Tensor,
                     offset: int) -> torch.Tensor:
    """rgb (H, W, C), alpha (H, W, 1) in [0, 1] -> padded rgb, fp32."""
    rgb = rgb.float()
    mask = (alpha.float() > 0).float()
    rgb = rgb * mask
    for _ in range(int(offset)):
        weight = _sum3(mask)
        border = _sum3(rgb) / (weight + 1e-7)
        rgb = torch.where(mask < 1.0, border, rgb)
        mask = (weight > 0).float()
    return rgb.clamp(0.0, 1.0)
