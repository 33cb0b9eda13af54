"""Jaccard index (IoU), an eval metric (counterpart of
``nunif_tpu/modules/jaccard.py``): thresholded IoU a channel and image,
averaged; an empty union scores 1.0."""
from __future__ import annotations

import torch


def jaccard_index(input, target, threshold=0.5) -> float:
    """input / target: (B, H, W, C), (H, W, C) or (H, W) tensors or
    arrays.  Returns a Python float."""
    input, target = torch.as_tensor(input), torch.as_tensor(target)
    if input.dim() == 2:
        input, target = input[..., None], target[..., None]
    if input.dim() == 3:
        input, target = input[None], target[None]
    assert input.shape == target.shape and input.dim() == 4
    a = (input >= threshold).float()
    b = (target >= threshold).float()
    inter = torch.sum(a * b, dim=(1, 2))          # (B, C)
    union = torch.sum(a, dim=(1, 2)) + torch.sum(b, dim=(1, 2)) - inter
    score = torch.where(union > 0, inter / union.clamp_min(1e-12),
                        torch.ones_like(union))
    return float(score.mean())
