"""waifu2x swin_unet, NHWC (counterpart of
``nunif_tpu/waifu2x/models/swin_unet.py``).

The whole family: 1x, 2x, 4x, 8x, the downscaled 4x trunk and the
``swin_unet_4xl`` factory.  A norm-free Swin block runs kernel K1; a block
with a LayerNorm (``layer_norm=True``) runs kernel K4 for its attention; the
stem's second conv runs kernel K2.  The rest (the cin = 3 stem conv,
PatchDown, PatchUp, the ``proj2`` skip, ToImage, the bicubic resizes) is
plain PyTorch, as the JAX package leaves it to XLA.  Module and parameter
names follow the flax tree, so ``models.flax_params`` maps checkpoints one
to one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import (I2IBaseModel, register_model, register_model_factory,
                       to_flax)
from ...modules.attention import SwinTransformerBlocks
from ...modules.conv import leaky_relu
from ...modules.permute import pixel_shuffle
from ...modules.resize import resize
from ...ops import _build, conv3x3 as _k2


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Linear in x's dtype (fp32 params cast to the compute dtype)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Conv3x3(nn.Module):
    """Plain 3x3 VALID conv for the cin = 3 stem conv, which the JAX package
    also computes outside any kernel (its XLA path: operands in x's dtype,
    an fp32 accumulator, the fp32 bias, one rounding).  So the conv runs in
    fp32 on x and the weights rounded to x's dtype (exact products, fp32
    sums; TF32 is off), adds the fp32 bias and rounds once to x's dtype."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        w = self.weight.to(x.dtype).float()
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, self.bias.float())
        return y.permute(0, 2, 3, 1).to(x.dtype)


class Im2ColConv3x3(nn.Module):
    """3x3 VALID conv + fused crop and leaky-ReLU through kernel K2."""

    def __init__(self, in_channels: int, features: int, crop: int = 0,
                 lrelu_slope=None):
        super().__init__()
        self.crop = crop
        self.lrelu_slope = lrelu_slope
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self._packed_key = None
        self._packed = None

    def kernel_layout(self, dtype: torch.dtype) -> list:
        """K2's form of the weights for x of ``dtype``: the packed kernel
        and the fp32 bias."""
        return [_k2.pack_stem_weights(self.weight.permute(2, 3, 1, 0), dtype),
                self.bias.detach().float().contiguous()]

    def packed_weights(self, dtype: torch.dtype):
        """``kernel_layout``, made again only when a parameter's storage or
        version changes (a weight load).  Under ``torch.export`` the buffers
        that ``models/export.py`` registered, or None: the kernel's op then
        packs them."""
        if torch.compiler.is_compiling():
            return _build.frozen_layout(self)
        key = (dtype,) + tuple((p.data_ptr(), p.device, p._version)
                               for p in (self.weight, self.bias))
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = tuple(self.kernel_layout(dtype))
            self._packed_key = key
        return self._packed

    def forward(self, x):
        packed = self.packed_weights(x.dtype) if x.is_cuda else None
        return _k2.stem_conv3x3(x.contiguous(), self.weight.permute(2, 3, 1, 0),
                                self.bias, crop=self.crop,
                                lrelu_slope=self.lrelu_slope, packed=packed)


class PatchDown(nn.Module):
    """2x2 stride-2 conv downsample (flax path ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 2, stride=2)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.conv.weight.to(x.dtype),
                     self.conv.bias.to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1).contiguous()


class PatchUp(nn.Module):
    """Linear -> pixel_shuffle(2); the kernel keeps torch pixel_shuffle's
    column order (column c*4 + dy*2 + dx)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels * 4)

    def forward(self, x):
        return pixel_shuffle(dense(x, self.proj), 2)


class ToImage(nn.Module):
    """Linear head -> pixel_shuffle(scale): ``proj`` for scale 1, 2 and 4;
    ``proj0`` -> leaky-ReLU 0.2 -> ``proj1`` for scale 8.  ``pre_shuffle``
    returns the (H, W, C*s*s) head output for the renderer's pre-shuffle
    blend."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int):
        super().__init__()
        self.scale_factor = s = scale_factor
        if s == 8:
            self.proj0 = nn.Linear(in_channels, out_channels * s * s)
            self.proj1 = nn.Linear(out_channels * s * s, out_channels * s * s)
        else:
            self.proj = nn.Linear(in_channels, out_channels * s * s)

    def forward(self, x, pre_shuffle: bool = False):
        if self.scale_factor == 8:
            x = dense(leaky_relu(dense(x, self.proj0), 0.2), self.proj1)
        else:
            x = dense(x, self.proj)
        if pre_shuffle or self.scale_factor == 1:
            return x
        return pixel_shuffle(x, self.scale_factor)


class SwinUNetBase(nn.Module):
    """U-Net over Swin blocks: patch (two valid 3x3 convs, crop 6) -> swin1
    -> down1 -> swin2 -> down2 -> swin3 (x3 depth) -> up2 -> swin4 (+skip)
    -> up1 -> swin5 (+skip) -> to_image.  Scale 1 and 2 run swin5 at C with
    the skip x3; scale 4 and 8 run it at 2C with the skip ``proj2(x3)``."""

    def __init__(self, in_channels=3, out_channels=3, base_dim=96,
                 scale_factor=1, norm="none"):
        super().__init__()
        if scale_factor not in (1, 2, 4, 8):
            raise ValueError(f"scale_factor {scale_factor} not in (1, 2, 4, 8)")
        c = base_dim
        heads = c // 16
        depth = 2
        ws = 6
        c5 = c if scale_factor in (1, 2) else 2 * c
        self.patch_conv0 = Conv3x3(in_channels, c // 2)
        self.patch_conv1 = Im2ColConv3x3(c // 2, c, crop=6, lrelu_slope=0.1)
        self.swin1 = SwinTransformerBlocks(c, heads, depth, ws, norm=norm)
        self.down1 = PatchDown(c, c * 2)
        self.swin2 = SwinTransformerBlocks(c * 2, heads, depth, ws, norm=norm)
        self.down2 = PatchDown(c * 2, c * 2)
        self.swin3 = SwinTransformerBlocks(c * 2, heads, depth * 3, ws,
                                           norm=norm)
        self.up2 = PatchUp(c * 2, c * 2)
        self.swin4 = SwinTransformerBlocks(c * 2, heads, depth, ws, norm=norm)
        self.up1 = PatchUp(c * 2, c5)
        self.proj2 = nn.Linear(c, c5) if c5 != c else None
        self.swin5 = SwinTransformerBlocks(c5, heads, depth, ws, norm=norm)
        self.to_image = ToImage(c5, out_channels, scale_factor)

    def forward(self, x, pre_shuffle: bool = False):
        x = leaky_relu(self.patch_conv0(x), 0.1)
        x2 = self.patch_conv1(x)
        if x2.shape[1] % 48 or x2.shape[2] % 48:
            raise ValueError(f"feature grid {tuple(x2.shape[1:3])} does not "
                             "divide 12 and 16: use a valid tile size")
        x3 = self.swin1(x2)
        x4 = self.swin2(self.down1(x3))
        x5 = self.swin3(self.down2(x4))
        x = self.swin4(self.up2(x5), skip=x4)
        skip = x3 if self.proj2 is None else dense(x3, self.proj2)
        x = self.swin5(self.up1(x), skip=skip)
        return self.to_image(x, pre_shuffle=pre_shuffle)


# valid input tiles: size % 48 == 16 (the feature grid divides 12 and 16)
_SWIN_TILE_CONSTRAINTS = ((48, 16),)


def _norm(layer_norm: bool) -> str:
    return "layernorm_nobias" if layer_norm else "none"


def _pre_antialias(x):
    """Bicubic (antialiased) resize 2x up, then back down."""
    h, w = x.shape[-3], x.shape[-2]
    x = resize(x, h * 2, w * 2, mode="bicubic", antialias=True)
    return resize(x, h, w, mode="bicubic", antialias=True)


class _SwinUNetModel(I2IBaseModel):
    """The I2I contract shared by the family's models."""
    i2i_default_tile_size = 256
    i2i_default_batch_size = 8
    i2i_tile_constraints = _SWIN_TILE_CONSTRAINTS


@register_model
class SwinUNet(_SwinUNetModel):
    model_name = "waifu2x.swin_unet_1x"
    i2i_scale = 1
    i2i_offset = 8
    i2i_blend_size = 4

    def __init__(self, in_channels: int = 3, out_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.unet = SwinUNetBase(in_channels, out_channels, 96, scale_factor=1)

    def forward(self, x, train: bool = False):
        z = self.unet(x)
        return z if train else z.clamp(0.0, 1.0)


@register_model
class SwinUNet2x(_SwinUNetModel):
    model_name = "waifu2x.swin_unet_2x"
    i2i_scale = 2
    i2i_offset = 16
    i2i_blend_size = 8

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = 96, layer_norm: bool = False,
                 pre_shuffle_output: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_dim = base_dim
        self.layer_norm = layer_norm
        self.pre_shuffle_output = pre_shuffle_output
        self.unet = SwinUNetBase(in_channels, out_channels, base_dim,
                                 scale_factor=2, norm=_norm(layer_norm))

    def forward(self, x, train: bool = False, pre_shuffle=None):
        """x (B, H, W, C) in the compute dtype.  ``train`` skips the final
        clip; ``pre_shuffle`` (default: the ``pre_shuffle_output`` setting)
        returns the (B, H', W', C*4) head output."""
        if pre_shuffle is None:
            pre_shuffle = self.pre_shuffle_output
        z = self.unet(x, pre_shuffle=pre_shuffle)
        return z if train else z.clamp(0.0, 1.0)


@register_model
class SwinUNet4x(_SwinUNetModel):
    model_name = "waifu2x.swin_unet_4x"
    i2i_scale = 4
    i2i_offset = 32
    i2i_blend_size = 16

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 pre_antialias: bool = False, base_dim: int = 96,
                 layer_norm: bool = False, pre_shuffle_output: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.pre_antialias = pre_antialias
        self.base_dim = base_dim
        self.layer_norm = layer_norm
        self.pre_shuffle_output = pre_shuffle_output
        self.unet = SwinUNetBase(in_channels, out_channels, base_dim,
                                 scale_factor=4, norm=_norm(layer_norm))

    def forward(self, x, train: bool = False, pre_shuffle=None):
        """As ``SwinUNet2x.forward``; the head output is (B, H', W', C*16)."""
        if pre_shuffle is None:
            pre_shuffle = self.pre_shuffle_output
        if self.pre_antialias:
            x = _pre_antialias(x)
        z = self.unet(x, pre_shuffle=pre_shuffle)
        return z if train else z.clamp(0.0, 1.0)


@register_model
class SwinUNet8x(_SwinUNetModel):
    """8x head on the 4x trunk.  ``i2i_scale`` is 4, as in the JAX package
    and the reference, although the output is 8x the input: drive it at
    model level, not through the tiled renderer."""
    model_name = "waifu2x.swin_unet_8x"
    i2i_scale = 4
    i2i_offset = 64
    i2i_blend_size = 32

    def __init__(self, in_channels: int = 3, out_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.unet = SwinUNetBase(in_channels, out_channels, 96, scale_factor=8)

    def forward(self, x, train: bool = False):
        z = self.unet(x)
        return z if train else z.clamp(0.0, 1.0)


@register_model
class SwinUNetDownscaled(_SwinUNetModel):
    """4x trunk + bicubic (antialiased) downscale by ``downscale_factor``:
    2 gives a 2x model, 4 a 1x model; shares weights with SwinUNet4x."""
    model_name = "waifu2x.swin_unet_downscaled"
    i2i_blend_size = 8

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 downscale_factor: int = 2, pre_antialias: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.downscale_factor = downscale_factor
        self.pre_antialias = pre_antialias
        self.unet = SwinUNetBase(in_channels, out_channels, 96, scale_factor=4)

    @property
    def i2i_scale(self):
        return 4 // self.downscale_factor

    @property
    def i2i_offset(self):
        return 32 // self.downscale_factor

    def forward(self, x, train: bool = False):
        if self.pre_antialias:
            x = _pre_antialias(x)
        z = self.unet(x)
        if not train:
            z = z.clamp(0.0, 1.0)
        h, w = z.shape[-3], z.shape[-2]
        z = resize(z, h // self.downscale_factor, w // self.downscale_factor,
                   mode="bicubic", antialias=True)
        return z if train else z.clamp(0.0, 1.0)


def swin_unet_4xl(**kwargs):
    """The widest model of the family: SwinUNet4x at base_dim 192 with
    LayerNorm blocks (12 heads); checkpoints record it as
    ``waifu2x.swin_unet_4x``."""
    return SwinUNet4x(base_dim=192, layer_norm=True, **kwargs)


register_model_factory("waifu2x.swin_unet_4xl", swin_unet_4xl)


def tamed_flax_params(model: nn.Module, seed: int) -> dict:
    """Seeded random weights for ``model`` in flax layout, made with numpy
    so that the JAX package and the port can be given the same arrays.

    Kernels are lecun-normal (clipped at 2 std), biases and relative-position
    tables N(0, 0.02), LayerNorm scales 1 + N(0, 0.02) (at N(0, 0.02) every
    normed activation would be ~0).  At such a random init swin_unet is
    chaotic (pre-clip output std in the hundreds) and outputs compare noise,
    so every ``fc2`` and ``attn/proj`` kernel is scaled by 0.1, the last head
    kernel (``to_image/proj``, or ``to_image/proj1`` at scale 8) by 0.05, and
    0.5 is added to its bias: the output then stays inside (0, 1) and bf16
    within a uint8 level of fp32.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
            if leaf == "scale":
                a = a + 1.0
        if key.endswith(("mlp/fc2/kernel", "attn/proj/kernel")):
            a = a * 0.1
        elif key.endswith(("to_image/proj/kernel", "to_image/proj1/kernel")):
            a = a * 0.05
        elif key.endswith(("to_image/proj/bias", "to_image/proj1/bias")):
            a = a + 0.5
        flat[key] = a.astype(np.float32)
    return flat
