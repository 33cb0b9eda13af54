"""LayerNorm and GroupNorm with flax's semantics (counterpart of
``nunif_tpu/modules/norm.py``, the Swin blocks' norms and flax
``nn.GroupNorm``)."""
from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis: epsilon ``eps`` (flax's
    1e-6 by default), the fast variance E[x^2] - E[x]^2 clipped at 0, statistics and normalisation in
    fp32, the result rounded once to x's dtype.

    flax's own ``LayerNorm(dtype=None)`` returns fp32 for a bf16 input and so
    promotes the rest of a bf16 Swin block to fp32; this one keeps x's dtype,
    the intended mixed-precision behaviour.  The flax path of ``weight`` is
    ``scale`` (``models.flax_params``)."""

    def __init__(self, dim: int, use_bias: bool = True, eps: float = 1e-6):
        super().__init__(dim, eps=eps, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class LayerNormNoBias(nn.Module):
    """The JAX package's ``LayerNormNoBias``: a scale-only ``LayerNorm`` at
    epsilon 1e-5, held as the child ``LayerNorm_0`` so that its weight's
    flax path is ``<name>/LayerNorm_0/scale``.  Like ``LayerNorm`` it keeps
    x's dtype where flax returns fp32 for a bf16 input."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, use_bias=False, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` on NHWC: statistics over (H, W, C / G) in fp32
    with the fast variance E[x^2] - E[x]^2, the result rounded once to x's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        g = x.float().reshape(B, H * W, self.num_groups, C // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        G = self.num_groups
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (g - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(B, H, W, C).to(x.dtype)
