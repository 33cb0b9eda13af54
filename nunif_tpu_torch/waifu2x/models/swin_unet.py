"""waifu2x swin_unet, NHWC (counterpart of
``nunif_tpu/waifu2x/models/swin_unet.py``).

Ported: ``waifu2x.swin_unet_2x`` with norm "none".  Every Swin block runs
kernel K1 and the stem's second conv runs kernel K2; the rest (the cin = 3
stem conv, PatchDown, PatchUp, ToImage) is plain PyTorch, as the JAX package
leaves it to XLA.  Module and parameter names follow the flax tree, so
``models.flax_params`` maps checkpoints one to one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import I2IBaseModel, register_model, to_flax
from ...modules.attention import SwinTransformerBlocks
from ...modules.conv import leaky_relu
from ...modules.permute import pixel_shuffle
from ...ops import conv3x3 as _k2


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Linear in x's dtype (fp32 params cast to the compute dtype)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Conv3x3(nn.Module):
    """Plain 3x3 VALID conv for the cin = 3 stem conv, which the JAX package
    also computes outside any kernel."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype))
        return y.permute(0, 2, 3, 1)


class Im2ColConv3x3(nn.Module):
    """3x3 VALID conv + fused crop and leaky-ReLU through kernel K2."""

    def __init__(self, in_channels: int, features: int, crop: int = 0,
                 lrelu_slope=None):
        super().__init__()
        self.crop = crop
        self.lrelu_slope = lrelu_slope
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return _k2.stem_conv3x3(x.contiguous(), self.weight.permute(2, 3, 1, 0),
                                self.bias, crop=self.crop,
                                lrelu_slope=self.lrelu_slope)


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
    """Linear head -> pixel_shuffle(scale); ``pre_shuffle`` returns the
    (H, W, C*s*s) head output for the renderer's pre-shuffle blend."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor
        self.proj = nn.Linear(in_channels, out_channels * scale_factor ** 2)

    def forward(self, x, pre_shuffle: bool = False):
        x = dense(x, self.proj)
        return x if pre_shuffle else pixel_shuffle(x, self.scale_factor)


class SwinUNetBase(nn.Module):
    """U-Net over Swin blocks, the 2x topology: patch (two valid 3x3 convs,
    crop 6) -> swin1 -> down1 -> swin2 -> down2 -> swin3 (x3 depth) -> up2
    -> swin4 (+skip) -> up1 -> swin5 (+skip) -> to_image.  The JAX class
    also builds the 1x/4x/8x heads, which are not ported yet."""

    def __init__(self, in_channels=3, out_channels=3, base_dim=96):
        super().__init__()
        c = base_dim
        heads = c // 16
        depth = 2
        ws = 6
        self.patch_conv0 = Conv3x3(in_channels, c // 2)
        self.patch_conv1 = Im2ColConv3x3(c // 2, c, crop=6, lrelu_slope=0.1)
        self.swin1 = SwinTransformerBlocks(c, heads, depth, ws)
        self.down1 = PatchDown(c, c * 2)
        self.swin2 = SwinTransformerBlocks(c * 2, heads, depth, ws)
        self.down2 = PatchDown(c * 2, c * 2)
        self.swin3 = SwinTransformerBlocks(c * 2, heads, depth * 3, ws)
        self.up2 = PatchUp(c * 2, c * 2)
        self.swin4 = SwinTransformerBlocks(c * 2, heads, depth, ws)
        self.up1 = PatchUp(c * 2, c)
        self.swin5 = SwinTransformerBlocks(c, heads, depth, ws)
        self.to_image = ToImage(c, out_channels, 2)

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
        x = self.swin5(self.up1(x), skip=x3)
        return self.to_image(x, pre_shuffle=pre_shuffle)


# valid input tiles: size % 48 == 16 (the feature grid divides 12 and 16)
_SWIN_TILE_CONSTRAINTS = ((48, 16),)


@register_model
class SwinUNet2x(I2IBaseModel):
    model_name = "waifu2x.swin_unet_2x"
    i2i_scale = 2
    i2i_offset = 16
    i2i_blend_size = 8
    i2i_default_tile_size = 256
    i2i_default_batch_size = 8
    i2i_tile_constraints = _SWIN_TILE_CONSTRAINTS

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_dim: int = 96, layer_norm: bool = False,
                 pre_shuffle_output: bool = False):
        super().__init__()
        if layer_norm:
            raise NotImplementedError(
                "swin_unet_2x(layer_norm=True) needs the window-attention "
                "kernel K4, which is not ported yet")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.base_dim = base_dim
        self.layer_norm = layer_norm
        self.pre_shuffle_output = pre_shuffle_output
        self.unet = SwinUNetBase(in_channels, out_channels, base_dim)

    def forward(self, x, train: bool = False, pre_shuffle=None):
        """x (B, H, W, C) in the compute dtype.  ``train`` skips the final
        clip; ``pre_shuffle`` (default: the ``pre_shuffle_output`` setting)
        returns the (B, H', W', C*4) head output."""
        if pre_shuffle is None:
            pre_shuffle = self.pre_shuffle_output
        z = self.unet(x, pre_shuffle=pre_shuffle)
        return z if train else z.clamp(0.0, 1.0)


def tamed_flax_params(model: nn.Module, seed: int) -> dict:
    """Seeded random weights for ``model`` in flax layout, made with numpy
    so that the JAX package and the port can be given the same arrays.

    Kernels are lecun-normal (clipped at 2 std), biases and relative-position
    tables N(0, 0.02).  At such a random init swin_unet is chaotic (pre-clip
    output std in the hundreds) and outputs compare noise, so every ``fc2``
    and ``attn/proj`` kernel is scaled by 0.1, ``to_image/proj/kernel`` by
    0.05, and 0.5 is added to ``to_image/proj/bias``: the output then stays
    inside (0, 1) and bf16 within a uint8 level of fp32.
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
        if key.endswith(("mlp/fc2/kernel", "attn/proj/kernel")):
            a = a * 0.1
        elif key.endswith("to_image/proj/kernel"):
            a = a * 0.05
        elif key.endswith("to_image/proj/bias"):
            a = a + 0.5
        flat[key] = a.astype(np.float32)
    return flat
