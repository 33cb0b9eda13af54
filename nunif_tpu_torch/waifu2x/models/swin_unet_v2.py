"""waifu2x swin_unet_v2 (the reference's winc_unet), NHWC (counterpart of
``nunif_tpu/waifu2x/models/swin_unet_v2.py``).

A dual-path stem (``IR``), a 3x3 patch conv cropped by 7, WACBlocks (pre-norm
window attention with a learned score bias, then a GLU conv MLP) at two
levels joined by residual ``PatchDown`` / ``PatchUp``, a pixel-shuffle head
(``ToImage``) and a learned source skip (``SourceResidual``, initialised to
a nearest-neighbour upscale).  1x / 2x / 4x models, the downscaled 4x trunk,
the ``swin_unet_v2_1xs`` factory and the reference's aliases.

No hand-written kernel: the JAX model reaches no Pallas kernel (its window
attention, ``modules/attention.py:WindowMHA2d``, is einsum and softmax).
Module and parameter names give the flax paths, so ``.nztm`` files pass
between the two packages; ``to_image/resampling`` keeps flax's HWIO layout.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...models import (I2IBaseModel, register_model, register_model_alias,
                       register_model_factory)
from ...modules.attention import WindowMHA2d, WindowScoreBias
from ...modules.conv import conv2d_nhwc, leaky_relu
from ...modules.norm import LayerNormNoBias
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_shuffle, pixel_unshuffle
from ...modules.resize import resize


class MLP(nn.Module):
    """1x1 conv MLP (flax paths ``w1``, ``w2``)."""

    def __init__(self, channels: int, mlp_ratio: float = 2):
        super().__init__()
        mid = int(channels * mlp_ratio)
        self.w1 = nn.Conv2d(channels, mid, 1)
        self.w2 = nn.Conv2d(mid, channels, 1)

    def forward(self, x):
        return conv2d_nhwc(leaky_relu(conv2d_nhwc(x, self.w1), 0.1), self.w2)


class GLUConvMLP(nn.Module):
    """1x1 conv, GLU over the channel halves, replication-padded k x k conv,
    leaky ReLU 0.2."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 mlp_ratio: float = 2):
        super().__init__()
        mid = int(channels * mlp_ratio)
        self.pad = (kernel_size - 1) // 2
        self.w1 = nn.Conv2d(channels, mid, 1)
        self.w2 = nn.Conv2d(mid // 2, channels, kernel_size)

    def forward(self, x):
        a, b = conv2d_nhwc(x, self.w1).chunk(2, dim=-1)
        x = replication_pad2d(a * torch.sigmoid(b), (self.pad,) * 4)
        return leaky_relu(conv2d_nhwc(x, self.w2), 0.2)


class WACBlock(nn.Module):
    """x + window MHA(norm(x)) with the learned score bias, then x + the
    conv MLP (``GLUConvMLP``, or ``MLP`` when ``conv_mlp`` is False)."""

    def __init__(self, channels: int, num_heads: int = 4, window_size=8,
                 mlp_ratio: float = 2, conv_mlp: bool = True,
                 shift: bool = False):
        super().__init__()
        ws = (tuple(window_size) if isinstance(window_size, (tuple, list))
              else (window_size, window_size))
        self.relative_bias = WindowScoreBias(ws)
        self.norm = LayerNormNoBias(channels)
        self.mha = WindowMHA2d(channels, num_heads, window_size=ws,
                               shift=(shift, shift))
        self.conv_mlp = (GLUConvMLP(channels, mlp_ratio=mlp_ratio) if conv_mlp
                         else MLP(channels, mlp_ratio=mlp_ratio))

    def forward(self, x):
        x = x + self.mha(self.norm(x), attn_mask=self.relative_bias())
        return x + self.conv_mlp(x)


class WACBlocks(nn.Module):
    def __init__(self, channels: int, num_heads: int = 4, window_size=8,
                 mlp_ratio: float = 2, num_layers: int = 2, conv_mlp=True,
                 shift=None):
        super().__init__()
        n = num_layers
        window = (list(window_size) if isinstance(window_size, (list, tuple))
                  else [window_size] * n)
        conv_mlp = (list(conv_mlp) if isinstance(conv_mlp, (list, tuple))
                    else [conv_mlp] * n)
        if shift is None:
            shift = [i % 2 == 1 for i in range(n)]
        self.num_layers = n
        for i in range(n):
            setattr(self, f"blocks_{i}", WACBlock(
                channels, num_heads=num_heads, window_size=window[i],
                mlp_ratio=mlp_ratio, conv_mlp=conv_mlp[i], shift=shift[i]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"blocks_{i}")(x)
        return x


def get_shift_config(num_layers: int):
    """The reference's shift pattern, odd layers shifted, reversed."""
    return tuple(reversed([i % 2 == 1 for i in range(num_layers)]))


class IR(nn.Module):
    """Dual-path stem: a 3x3 conv beside two WACBlocks at half resolution
    (pixel unshuffle / shuffle), concatenated."""

    def __init__(self, in_channels: int = 3, out_channels: int = 32):
        super().__init__()
        half = out_channels // 2
        self.path1_0 = nn.Conv2d(in_channels, half, 3)
        self.path2_1 = nn.Conv2d(in_channels * 4, half * 4, 1)
        self.path2_2 = WACBlock(half * 4, num_heads=2, window_size=8,
                                mlp_ratio=1, shift=True)
        self.path2_3 = WACBlock(half * 4, num_heads=2, window_size=8,
                                mlp_ratio=1, shift=False)

    def forward(self, x):
        x1 = leaky_relu(conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)),
                                    self.path1_0), 0.2)
        x2 = conv2d_nhwc(pixel_unshuffle(x, 2), self.path2_1)
        x2 = pixel_shuffle(self.path2_3(self.path2_2(x2)), 2)
        return torch.cat([x1, x2], dim=-1)


class PatchDown(nn.Module):
    """2x2 stride-2 conv; with ``residual``, plus the unshuffled input
    averaged over groups of channels (the DC-AE shortcut)."""

    def __init__(self, in_channels: int, out_channels: int,
                 residual: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.residual = residual
        self.conv = nn.Conv2d(in_channels, out_channels, 2)

    def forward(self, x):
        h = leaky_relu(conv2d_nhwc(x, self.conv, stride=2), 0.2)
        if not self.residual:
            return h
        group = x.shape[-1] * 4 // self.out_channels
        sc = pixel_unshuffle(x, 2)
        b, hh, ww, _ = sc.shape
        return sc.reshape(b, hh, ww, self.out_channels, group).mean(-1) + h


class PatchUp(nn.Module):
    """1x1 conv to 4x channels and pixel shuffle; with ``residual``, plus
    the input's channels repeated and shuffled."""

    def __init__(self, in_channels: int, out_channels: int,
                 residual: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.residual = residual
        self.proj = nn.Conv2d(in_channels, out_channels * 4, 1)

    def forward(self, x):
        h = pixel_shuffle(leaky_relu(conv2d_nhwc(x, self.proj), 0.2), 2)
        if not self.residual:
            return h
        repeats = self.out_channels * 4 // x.shape[-1]
        return pixel_shuffle(x.repeat_interleave(repeats, dim=-1), 2) + h


class ToImage(nn.Module):
    """1x1 conv to C * s * s, pixel shuffle, crop s a side."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor
        s = scale_factor
        self.proj = nn.Conv2d(in_channels, out_channels * s * s, 1)

    def forward(self, x):
        s = self.scale_factor
        x = conv2d_nhwc(x, self.proj)
        if s > 1:
            x = pixel_shuffle(x, s)
        return crop2d(x, (s,) * 4)


def nearest_resample_kernel(scale_factor: int, source_channels: int = 3,
                            out_channels: int = 3) -> np.ndarray:
    """HWIO (3, 3, in, out * s * s) kernel of a nearest-neighbour upscale:
    output channel c * s * s + j takes source channel c at the centre."""
    s = scale_factor
    k = np.zeros((3, 3, source_channels, out_channels * s * s), np.float32)
    for c in range(out_channels):
        k[1, 1, c, c * s * s:(c + 1) * s * s] = 1.0
    return k


class SourceResidual(nn.Module):
    """A learned 3x3 resampling of the source (replication-padded by 1,
    pixel-shuffled by s, cropped or zero-padded to x's size) plus x times a
    learned scalar.  ``resampling`` is held in flax's HWIO layout."""

    def __init__(self, out_channels: int, scale_factor: int,
                 source_channels: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.resampling = nn.Parameter(torch.from_numpy(nearest_resample_kernel(
            scale_factor, source_channels, out_channels)))
        self.scale_bias = nn.Parameter(torch.zeros(1))

    def initial_resampling(self) -> torch.Tensor:
        """The nearest-neighbour kernel the flax module initialises to."""
        c_in, c_out = self.resampling.shape[2], self.resampling.shape[3]
        s = self.scale_factor
        return torch.from_numpy(nearest_resample_kernel(s, c_in, c_out // (s * s)))

    def forward(self, x, src):
        s = self.scale_factor
        w = cast_param(self.resampling, x.dtype).permute(3, 2, 0, 1)
        srcp = replication_pad2d(src.to(x.dtype), (1, 1, 1, 1))
        r = F.conv2d(srcp.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
        if s > 1:
            r = pixel_shuffle(r, s)
        unpad = (x.shape[1] - r.shape[1]) // 2
        if unpad < 0:
            r = crop2d(r, (-unpad,) * 4)
        elif unpad > 0:
            r = F.pad(r, (0, 0, unpad, unpad, unpad, unpad))
        return r + x * cast_param(self.scale_bias, x.dtype)


class SwinUNetV2Base(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = 96, lv1_mlp_ratio: float = 2,
                 lv2_mlp_ratio: float = 1, lv2_ratio: float = 4,
                 first_layers: int = 2, last_layers: int = 3,
                 scale_factor: int = 2):
        super().__init__()
        C = base_dim
        C2 = int(C * lv2_ratio)
        heads, heads2 = max(C // 32, 2), max(C2 // 32, 2)
        first_windows = ([8, 6][:first_layers] if first_layers <= 2
                         else [8, 6] + [8] * (first_layers - 2))
        self.ir = IR(in_channels, 32)
        self.patch = nn.Conv2d(32, C, 3)
        self.wac1 = WACBlocks(C, mlp_ratio=lv1_mlp_ratio,
                              window_size=first_windows, num_heads=heads,
                              num_layers=first_layers,
                              shift=get_shift_config(first_layers))
        self.down1 = PatchDown(C, C2, residual=True)
        self.wac2 = WACBlocks(C2, mlp_ratio=lv2_mlp_ratio, window_size=8,
                              num_heads=heads2, num_layers=4,
                              shift=get_shift_config(4))
        self.up1 = PatchUp(C2, C, residual=True)
        self.wac3 = WACBlocks(C, mlp_ratio=lv1_mlp_ratio, window_size=8,
                              num_heads=heads, num_layers=last_layers,
                              conv_mlp=[True] * (last_layers - 1) + [False],
                              shift=get_shift_config(last_layers))
        self.to_residual_image = ToImage(C, out_channels, scale_factor)
        self.to_image = SourceResidual(out_channels, scale_factor, in_channels)

    def forward(self, x):
        src = x
        x = self.ir(x)
        x = leaky_relu(crop2d(conv2d_nhwc(x, self.patch), (7,) * 4), 0.2)
        x1 = self.wac1(x)
        x = self.up1(self.wac2(self.down1(x1))) + x1
        x = self.to_residual_image(self.wac3(x))
        return self.to_image(x, src)


def _v2_tile_ok(size: int) -> bool:
    return size > 16 and (size - 16) % 12 == 0 and (size - 16) % 16 == 0


class _SwinUNetV2(I2IBaseModel):
    base_dim_default = 96

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = None, lv1_mlp_ratio: float = 2,
                 lv2_mlp_ratio: float = 2, lv2_ratio: float = 2,
                 first_layers: int = 2, last_layers: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_dim = self.base_dim_default if base_dim is None else base_dim
        self.lv1_mlp_ratio = lv1_mlp_ratio
        self.lv2_mlp_ratio = lv2_mlp_ratio
        self.lv2_ratio = lv2_ratio
        self.first_layers = first_layers
        self.last_layers = last_layers
        self.unet = SwinUNetV2Base(
            in_channels, out_channels, base_dim=self.base_dim,
            lv1_mlp_ratio=lv1_mlp_ratio, lv2_mlp_ratio=lv2_mlp_ratio,
            lv2_ratio=lv2_ratio, first_layers=first_layers,
            last_layers=last_layers, scale_factor=self.i2i_scale)

    def is_valid_tile_size(self, size: int) -> bool:
        return _v2_tile_ok(size)

    def forward(self, x, train: bool = False):
        z = self.unet(x)
        return z if train else z.clamp(0.0, 1.0)


@register_model
class SwinUNet1xV2(_SwinUNetV2):
    model_name = "waifu2x.swin_unet_v2_1x"
    i2i_scale = 1
    i2i_offset = 9
    i2i_blend_size = 4
    base_dim_default = 64


@register_model
class SwinUNet2xV2(_SwinUNetV2):
    model_name = "waifu2x.swin_unet_v2_2x"
    i2i_scale = 2
    i2i_offset = 18
    i2i_blend_size = 8
    base_dim_default = 96


@register_model
class SwinUNet4xV2(_SwinUNetV2):
    model_name = "waifu2x.swin_unet_v2_4x"
    i2i_scale = 4
    i2i_offset = 36
    i2i_blend_size = 16
    base_dim_default = 128


@register_model
class SwinUNetV2Downscaled(I2IBaseModel):
    """The 4x trunk, then an antialiased bicubic downscale by
    ``downscale_factor`` (2: a 2x model, 4: a 1x model)."""
    model_name = "waifu2x.swin_unet_v2_downscaled"
    i2i_blend_size = 8

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = 128, downscale_factor: int = 2):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_dim = base_dim
        self.downscale_factor = downscale_factor
        self.unet = SwinUNetV2Base(in_channels, out_channels, base_dim=base_dim,
                                   lv2_mlp_ratio=2, lv2_ratio=2, scale_factor=4)

    @property
    def i2i_scale(self):
        return 4 // self.downscale_factor

    @property
    def i2i_offset(self):
        return {2: 18, 4: 9}[self.downscale_factor]

    def is_valid_tile_size(self, size: int) -> bool:
        return _v2_tile_ok(size)

    def forward(self, x, train: bool = False):
        z = self.unet(x)
        if not train:
            z = z.clamp(0.0, 1.0)
        h, w = z.shape[-3], z.shape[-2]
        z = resize(z, h // self.downscale_factor, w // self.downscale_factor,
                   mode="bicubic", antialias=True)
        return z if train else z.clamp(0.0, 1.0)


def swin_unet_v2_1xs(**kwargs):
    """The small 1x model: base 32, one layer first and last, MLP ratio 1;
    checkpoints record it as ``waifu2x.swin_unet_v2_1x`` with these kwargs."""
    return SwinUNet1xV2(base_dim=32, first_layers=1, last_layers=1,
                        lv1_mlp_ratio=1, lv2_mlp_ratio=1, **kwargs)


register_model_alias("waifu2x.winc_unet_1x", "waifu2x.swin_unet_v2_1x")
register_model_alias("waifu2x.swin_unet_1x_v2", "waifu2x.swin_unet_v2_1x")
register_model_alias("waifu2x.winc_unet_2x", "waifu2x.swin_unet_v2_2x")
register_model_alias("waifu2x.winc_unet_4x", "waifu2x.swin_unet_v2_4x")
register_model_factory("waifu2x.swin_unet_v2_1xs", swin_unet_v2_1xs)
