"""waifu2x CUNet / UpCUNet, the cascaded U-Nets, NHWC (counterpart of
``nunif_tpu/waifu2x/models/cunet.py``).

UNet1 then UNet2 on UNet1's output, each of VALID 3x3 conv pairs with SE
blocks and negative-pad skips; the output is UNet1's output cropped by 20
plus UNet2's.  Offsets 28 (cunet) and 36 (upcunet, whose UNet1 ends in a
stride-2 deconv), tiles a multiple of 4.  The stride-2 up-convs are flax
``ConvTranspose(transpose_kernel=True)`` in the JAX model, whose kernel
``(kh, kw, O, I)`` is torch's ``ConvTranspose2d`` weight ``(I, O, kh, kw)``
by the 4-D rule of ``models/flax_params.py``, so they run as
``F.conv_transpose2d`` (torch's output size equals flax's VALID one).
No hand-written kernel: the JAX model reaches no Pallas kernel.  Module
names give the flax paths (``unet1/conv1/conv_0``, ``.../seblock/conv1``,
``unet1/conv2_up``, ``unet1/conv_bottom``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...models import I2IBaseModel, register_model
from ...modules.conv import conv2d, leaky_relu


def _crop(x: torch.Tensor, c: int) -> torch.Tensor:
    """Crop c pixels from each border of an NCHW view."""
    return x[..., c:x.shape[-2] - c, c:x.shape[-1] - c]


def _deconv(x: torch.Tensor, layer: nn.ConvTranspose2d,
            padding: int = 0) -> torch.Tensor:
    """Stride-2 transposed conv in x's dtype; ``padding`` crops the full
    output by that many pixels a side, as torch's argument does."""
    return F.conv_transpose2d(x, cast_param(layer.weight, x.dtype),
                              cast_param(layer.bias, x.dtype), stride=2,
                              padding=padding)


class SEBlock(nn.Module):
    """Squeeze-and-excitation (reduction 8, biased 1x1 convs); the mean is
    taken in fp32 and rounded to x's dtype, as the JAX block does."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels // reduction, 1)
        self.conv2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x):
        z = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        z = conv2d(torch.relu(conv2d(z, self.conv1)), self.conv2)
        return x * torch.sigmoid(z)


class UNetConv(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 se: bool):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, mid_channels, 3)
        self.conv_2 = nn.Conv2d(mid_channels, out_channels, 3)
        self.seblock = SEBlock(out_channels) if se else None

    def forward(self, x):
        x = leaky_relu(conv2d(x, self.conv_0), 0.1)
        x = leaky_relu(conv2d(x, self.conv_2), 0.1)
        return x if self.seblock is None else self.seblock(x)


def _bottom(out_channels: int, deconv: bool) -> nn.Module:
    if deconv:
        return nn.ConvTranspose2d(64, out_channels, 4, stride=2)
    return nn.Conv2d(64, out_channels, 3)


def _apply_bottom(x, layer, deconv: bool):
    # torch ConvTranspose2d(64, out, 4, stride=2, padding=3)
    return _deconv(x, layer, padding=3) if deconv else conv2d(x, layer)


class UNet1(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, deconv: bool):
        super().__init__()
        self.deconv = deconv
        self.conv1 = UNetConv(in_channels, 32, 64, se=False)
        self.conv1_down = nn.Conv2d(64, 64, 2)
        self.conv2 = UNetConv(64, 128, 64, se=True)
        self.conv2_up = nn.ConvTranspose2d(64, 64, 2, stride=2)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.conv_bottom = _bottom(out_channels, deconv)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = leaky_relu(conv2d(x1, self.conv1_down, stride=2), 0.1)
        x2 = leaky_relu(_deconv(self.conv2(x2), self.conv2_up), 0.1)
        x3 = leaky_relu(conv2d(_crop(x1, 4) + x2, self.conv3), 0.1)
        return _apply_bottom(x3, self.conv_bottom, self.deconv)


class UNet2(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, deconv: bool):
        super().__init__()
        self.deconv = deconv
        self.conv1 = UNetConv(in_channels, 32, 64, se=False)
        self.conv1_down = nn.Conv2d(64, 64, 2)
        self.conv2 = UNetConv(64, 64, 128, se=True)
        self.conv2_down = nn.Conv2d(128, 128, 2)
        self.conv3 = UNetConv(128, 256, 128, se=True)
        self.conv3_up = nn.ConvTranspose2d(128, 128, 2, stride=2)
        self.conv4 = UNetConv(128, 64, 64, se=True)
        self.conv4_up = nn.ConvTranspose2d(64, 64, 2, stride=2)
        self.conv5 = nn.Conv2d(64, 64, 3)
        self.conv_bottom = _bottom(out_channels, deconv)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = leaky_relu(conv2d(x1, self.conv1_down, stride=2), 0.1)
        x2 = self.conv2(x2)
        x3 = leaky_relu(conv2d(x2, self.conv2_down, stride=2), 0.1)
        x3 = leaky_relu(_deconv(self.conv3(x3), self.conv3_up), 0.1)
        x4 = self.conv4(_crop(x2, 4) + x3)
        x4 = leaky_relu(_deconv(x4, self.conv4_up), 0.1)
        x5 = leaky_relu(conv2d(_crop(x1, 16) + x4, self.conv5), 0.1)
        return _apply_bottom(x5, self.conv_bottom, self.deconv)


@register_model
class CUNet(I2IBaseModel):
    model_name = "waifu2x.cunet"
    i2i_scale = 1
    i2i_offset = 28
    i2i_blend_size = 4
    i2i_default_tile_size = 256
    i2i_tile_constraints = ((4, 0),)

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 no_clip: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.no_clip = no_clip
        self.unet1 = UNet1(in_channels, out_channels,
                           deconv=self.i2i_scale == 2)
        self.unet2 = UNet2(out_channels, out_channels, deconv=False)

    def forward(self, x, train: bool = False):
        """x (B, H, W, C) in the compute dtype.  ``train`` returns (z,
        UNet1's cropped output) unclipped, the deep-supervision pair."""
        z1 = self.unet1(x.permute(0, 3, 1, 2))
        if not self.no_clip:
            z1 = z1.clamp(0.0, 1.0)
        z2 = self.unet2(z1)
        z1c = _crop(z1, 20)
        z = (z1c + z2).permute(0, 2, 3, 1)
        if train:
            return z, z1c.permute(0, 2, 3, 1)
        return z.clamp(0.0, 1.0)


@register_model
class UpCUNet(CUNet):
    model_name = "waifu2x.upcunet"
    i2i_scale = 2
    i2i_offset = 36
