"""Fast-Fourier-convolution spectral unit, NHWC (counterpart of
``nunif_tpu/modules/fourier_unit.py``).

The 2-D DFT over H, W (``spectral.dft2``, products with cos / sin bases,
as the JAX package computes it), real and imaginary parts stacked on the
channels, a 1x1 conv, LayerNorm and ReLU in the frequency domain, the real
part of the inverse DFT, and an optional shortcut.  The spectral part runs
in fp32 whatever x's dtype, as in the JAX module.  Used by the iw3 inpaint
FFC discriminator.
"""
from __future__ import annotations

import torch
from torch import nn

from .conv import conv2d_nhwc
from .norm import LayerNorm
from .spectral import dft2, idft2


class FourierUnit(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 residual: bool = True):
        super().__init__()
        self.residual = residual
        self.conv = nn.Conv2d(in_channels * 2, out_channels * 2, 1, bias=False)
        self.norm = LayerNorm(out_channels * 2)
        self.identity = (nn.Conv2d(in_channels, out_channels, 1)
                         if residual and in_channels != out_channels else None)

    def forward(self, x):
        re, im = dft2(x)
        z = self.norm(conv2d_nhwc(torch.cat([re, im], dim=-1), self.conv))
        re, im = torch.relu(z).chunk(2, dim=-1)
        z = idft2(re, im).to(x.dtype)
        if self.residual:
            shortcut = x if self.identity is None else \
                conv2d_nhwc(x, self.identity)
            z = z + shortcut
        return z
