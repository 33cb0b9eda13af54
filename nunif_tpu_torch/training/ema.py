"""EMA of model parameters (counterpart of ``nunif_tpu/training/ema.py``):
{name: fp32 tensor}, updated in place after each finite step."""
from __future__ import annotations

import torch


@torch.no_grad()
def ema_init(module) -> dict:
    return {name: p.detach().clone() for name, p in module.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict, module, decay: float):
    """ema = ema * decay + p * (1 - decay), each product rounded as in the
    JAX function."""
    for name, p in module.named_parameters():
        e = ema[name]
        e.mul_(decay).add_(p.detach().to(e.dtype) * (1.0 - decay))
