"""LayerNorm with flax ``nn.LayerNorm`` semantics."""
from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, the fast
    variance E[x^2] - E[x]^2 clipped at 0, statistics and normalisation in
    fp32, the result rounded once to x's dtype.

    flax's own ``LayerNorm(dtype=None)`` returns fp32 for a bf16 input and so
    promotes the rest of a bf16 Swin block to fp32; this one keeps x's dtype,
    the intended mixed-precision behaviour.  The flax path of ``weight`` is
    ``scale`` (``models.flax_params``)."""

    def __init__(self, dim: int, use_bias: bool = True):
        super().__init__(dim, eps=1e-6, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)
