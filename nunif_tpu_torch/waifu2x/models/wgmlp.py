"""waifu2x.wgmlp_4x, the window-gMLP 4x net, NHWC (counterpart of
``nunif_tpu/waifu2x/models/wgmlp.py``).

A stem with a dilated context stack (``Overscan``: replication pad 7, 3x3
convs at dilation 1, 2 and 3 cropped to a common size and fused), a patch
conv cropped by 7, windowed gMLP blocks (window 8, each followed by a GLU
conv MLP) at two levels joined by swin_unet_v2's residual ``PatchDown`` /
``PatchUp``, and swin_unet_v2's ``ToImage`` and ``SourceResidual`` at 4x.
No hand-written kernel: the JAX model reaches no Pallas kernel
(``WindowGMLP2d`` is plain).  Module names give the flax paths.
"""
from __future__ import annotations

import torch
from torch import nn

from ...models import I2IBaseModel, register_model
from ...modules.attention import WindowGMLP2d
from ...modules.conv import conv2d_nhwc, leaky_relu
from ...modules.norm import LayerNormNoBias
from ...modules.pad import crop2d, replication_pad2d
from .swin_unet_v2 import (MLP, GLUConvMLP, PatchDown, PatchUp,
                           SourceResidual, ToImage, _v2_tile_ok,
                           get_shift_config)


class WGMLPBlock(nn.Module):
    """Windowed gMLP (its own residual; ``norm1`` on the input, ``norm2``
    on the gate) then x + the conv MLP."""

    def __init__(self, channels: int, window_size: int = 8,
                 mlp_ratio: float = 2, conv_mlp: bool = True,
                 shift: bool = False):
        super().__init__()
        self.norm1 = LayerNormNoBias(channels)
        self.norm2 = LayerNormNoBias(channels)
        self.gmlp = WindowGMLP2d(channels, window_size, mlp_ratio=1,
                                 shift=shift)
        self.conv_mlp = (GLUConvMLP(channels, mlp_ratio=mlp_ratio) if conv_mlp
                         else MLP(channels, mlp_ratio=mlp_ratio))

    def forward(self, x):
        x = self.gmlp(x, self.norm1, self.norm2)
        return x + self.conv_mlp(x)


class WGMLPBlocks(nn.Module):
    def __init__(self, channels: int, mlp_ratio: float = 2,
                 num_layers: int = 2, conv_mlp=True, shift=None):
        super().__init__()
        n = num_layers
        conv_mlp = (list(conv_mlp) if isinstance(conv_mlp, (list, tuple))
                    else [conv_mlp] * n)
        shift = get_shift_config(n) if shift is None else shift
        self.num_layers = n
        for i in range(n):
            setattr(self, f"blocks_{i}", WGMLPBlock(
                channels, 8, mlp_ratio=mlp_ratio, conv_mlp=conv_mlp[i],
                shift=shift[i]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"blocks_{i}")(x)
        return x


class Overscan(nn.Module):
    """Dilated context: convs at dilation 1, 2, 3 on the input padded by 7,
    cropped to the last one's size, concatenated and fused to C."""

    def __init__(self, channels: int):
        super().__init__()
        C = channels
        self.conv1 = nn.Conv2d(C, C, 3)
        self.conv2 = nn.Conv2d(C, C // 2, 3, dilation=2)
        self.conv3 = nn.Conv2d(C // 2, C // 2, 3, dilation=3)
        self.fuse_0 = nn.Conv2d(C * 2, C, 3)
        self.fuse_2 = nn.Conv2d(C, C, 1)

    def forward(self, x):
        x = replication_pad2d(x, (1 + 2 + 3 + 1,) * 4)
        x1 = leaky_relu(conv2d_nhwc(x, self.conv1), 0.2)
        x2 = leaky_relu(conv2d_nhwc(x1, self.conv2, dilation=2), 0.2)
        x3 = leaky_relu(conv2d_nhwc(x2, self.conv3, dilation=3), 0.2)
        x4 = torch.cat([crop2d(x1, (2 + 3,) * 4), crop2d(x2, (3,) * 4), x3],
                       dim=-1)
        h = leaky_relu(conv2d_nhwc(x4, self.fuse_0), 0.2)
        return conv2d_nhwc(h, self.fuse_2)


class IR(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 16):
        super().__init__()
        self.patch = nn.Conv2d(in_channels, out_channels, 3)
        self.overscan = Overscan(out_channels)
        self.fusion = nn.Conv2d(out_channels * 2, out_channels, 3)

    def forward(self, x):
        h = leaky_relu(conv2d_nhwc(replication_pad2d(x, (1,) * 4),
                                   self.patch), 0.2)
        h = torch.cat([h, self.overscan(h)], dim=-1)
        return conv2d_nhwc(replication_pad2d(h, (1,) * 4), self.fusion)


class WGMLPBase(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = 128, lv1_mlp_ratio: float = 2,
                 lv2_mlp_ratio: float = 2, first_layers: int = 2,
                 last_layers: int = 3, scale_factor: int = 4):
        super().__init__()
        C = base_dim
        self.ir = IR(in_channels, 16)
        self.patch = nn.Conv2d(16, C, 3)
        self.wgmlp1 = WGMLPBlocks(C, mlp_ratio=lv1_mlp_ratio,
                                  num_layers=first_layers)
        self.down1 = PatchDown(C, C * 2, residual=True)
        self.wgmlp2 = WGMLPBlocks(C * 2, mlp_ratio=lv2_mlp_ratio, num_layers=4)
        self.up1 = PatchUp(C * 2, C, residual=True)
        self.wgmlp3 = WGMLPBlocks(C, mlp_ratio=lv1_mlp_ratio,
                                  num_layers=last_layers,
                                  conv_mlp=[True] * (last_layers - 1) + [False])
        self.to_residual_image = ToImage(C, out_channels, scale_factor)
        self.to_image = SourceResidual(out_channels, scale_factor, in_channels)

    def forward(self, x):
        src = x
        x = self.ir(x)
        x = leaky_relu(crop2d(conv2d_nhwc(x, self.patch), (7,) * 4), 0.2)
        x1 = self.wgmlp1(x)
        x = self.up1(self.wgmlp2(self.down1(x1))) + x1
        x = self.to_residual_image(self.wgmlp3(x))
        return self.to_image(x, src)


@register_model
class WGMLP4x(I2IBaseModel):
    model_name = "waifu2x.wgmlp_4x"
    i2i_scale = 4
    i2i_offset = 36
    i2i_blend_size = 16

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = 128, lv1_mlp_ratio: float = 2,
                 lv2_mlp_ratio: float = 2):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_dim = base_dim
        self.lv1_mlp_ratio = lv1_mlp_ratio
        self.lv2_mlp_ratio = lv2_mlp_ratio
        self.unet = WGMLPBase(in_channels, out_channels, base_dim=base_dim,
                              lv1_mlp_ratio=lv1_mlp_ratio,
                              lv2_mlp_ratio=lv2_mlp_ratio, scale_factor=4)

    def is_valid_tile_size(self, size: int) -> bool:
        return _v2_tile_ok(size)

    def forward(self, x, train: bool = False):
        z = self.unet(x)
        return z if train else z.clamp(0.0, 1.0)
