"""Convolution helpers (counterpart of ``nunif_tpu/modules/conv.py``).

Convs run on NCHW views of NHWC tensors (``x.permute(0, 3, 1, 2)``), which
are ``channels_last`` in memory, so cuDNN keeps the NHWC layout and no
activation is copied between layouts.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import cast_param


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def conv2d(x: torch.Tensor, layer: nn.Conv2d, stride: int = 1,
           padding=0) -> torch.Tensor:
    """flax ``nn.Conv(dtype=x.dtype)`` with ``layer``'s fp32 weights: the
    weight and bias cast to x's dtype (cached per weight load), the weight
    kept ``channels_last``.  x is NCHW (a channels_last view)."""
    return F.conv2d(x, cast_param(layer.weight, x.dtype, torch.channels_last),
                    cast_param(layer.bias, x.dtype), stride, padding)


class ConvTranspose2dTorch(nn.Module):
    """Transposed conv with torch's output size, (n - 1) * stride + kernel -
    2 * padding, on NCHW (channels_last) views.

    ``weight`` (out, in, k, k) is the JAX module's ``(k, k, in, out)``
    kernel by the 4-D rule of ``models/flax_params.py``: the OIHW kernel of
    a forward conv over the stride-dilated input with padding k - 1 - p,
    which is not torch's ``ConvTranspose2d`` layout.  The same function is
    ``conv_transpose2d`` with that kernel flipped and its in / out swapped.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 2, padding: int = 0):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(features, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        w = cast_param(self.weight, x.dtype).flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, w, cast_param(self.bias, x.dtype),
                                  stride=self.stride, padding=self.padding)
