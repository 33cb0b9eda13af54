"""DPT decoder head of Depth-Anything, NHWC (counterpart of
``nunif_tpu/iw3/depth/dpt.py``).

Per-level 1x1 projections, a resize pyramid (4x and 2x transposed convs,
identity, stride-2 conv), 3x3 ``layer*_rn`` convs, RefineNet fusion with
residual conv units, and the two-stage output head (ReLU for relative
depth, sigmoid * max_depth for metric).  Plain PyTorch: the JAX package
leaves the head to XLA.  Convolutions run in x's dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...modules.resize import resize


def conv(x: torch.Tensor, layer: nn.Conv2d, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """NHWC conv in x's dtype ("SAME" 3x3 at stride 1 is padding 1)."""
    bias = None if layer.bias is None else cast_param(layer.bias, x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), cast_param(layer.weight, x.dtype), bias,
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose(x: torch.Tensor, layer: nn.ConvTranspose2d,
                   stride: int) -> torch.Tensor:
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           cast_param(layer.weight, x.dtype),
                           cast_param(layer.bias, x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)


def _interp(x, h, w):
    # bilinear, align_corners=True, through the resize matrices
    return resize(x, h, w, mode="bilinear", antialias=False,
                  align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3)
        self.conv2 = nn.Conv2d(features, features, 3)

    def forward(self, x):
        h = conv(F.relu(x), self.conv1, padding=1)
        return x + conv(F.relu(h), self.conv2, padding=1)


class FeatureFusionBlock(nn.Module):
    """``resConfUnit1`` exists only where the block fuses a skip (``res``),
    as in the flax tree."""

    def __init__(self, features: int, fuse: bool = True):
        super().__init__()
        if fuse:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None, out_hw=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[1] * 2, x.shape[2] * 2)
        return conv(_interp(x, *out_hw), self.out_conv)


class DPTHead(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int],
                 in_dim: int, max_depth: float = 0.0):
        super().__init__()
        oc = tuple(out_channels)
        self.max_depth = max_depth
        for i in range(4):
            self.add_module(f"projects_{i}", nn.Conv2d(in_dim, oc[i], 1))
        self.resize_0 = nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(oc[3], oc[3], 3, stride=2)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn",
                            nn.Conv2d(oc[i], features, 3, bias=False))
        self.refinenet4 = FeatureFusionBlock(features, fuse=False)
        self.refinenet3 = FeatureFusionBlock(features)
        self.refinenet2 = FeatureFusionBlock(features)
        self.refinenet1 = FeatureFusionBlock(features)
        self.output_conv1 = nn.Conv2d(features, features // 2, 3)
        self.output_conv2_0 = nn.Conv2d(features // 2, 32, 3)
        self.output_conv2_2 = nn.Conv2d(32, 1, 1)

    # The forward runs in stages, each batched over frames; Video Depth
    # Anything's head (``vda.DPTHeadTemporal``) puts its temporal modules
    # between them.
    def levels(self, feats, patch_hw):
        """Token maps -> the resize pyramid's four levels."""
        ph, pw = patch_hw
        B = feats[0].shape[0]
        levels = []
        for i, tokens in enumerate(feats):
            x = conv(tokens.reshape(B, ph, pw, tokens.shape[-1]),
                     getattr(self, f"projects_{i}"))
            if i == 0:
                x = conv_transpose(x, self.resize_0, 4)
            elif i == 1:
                x = conv_transpose(x, self.resize_1, 2)
            elif i == 3:
                # torch Conv2d(stride 2, padding 1) alignment
                x = conv(x, self.resize_3, stride=2, padding=1)
            levels.append(x)
        return levels

    def rn(self, levels):
        return [conv(levels[i], getattr(self, f"layer{i + 1}_rn"), padding=1)
                for i in range(4)]

    def final(self, p3, rn1, rn0, patch_hw):
        """Fusion paths 2 and 1 and the output head."""
        ph, pw = patch_hw
        p2 = self.refinenet2(p3, rn1, out_hw=rn0.shape[1:3])
        p1 = self.refinenet1(p2, rn0)
        out = conv(p1, self.output_conv1, padding=1)
        out = _interp(out, ph * 14, pw * 14)
        out = F.relu(conv(out, self.output_conv2_0, padding=1))
        out = conv(out, self.output_conv2_2)
        if self.max_depth > 0:
            return torch.sigmoid(out.float()) * self.max_depth
        return F.relu(out)  # (B, H, W, 1)

    def forward(self, feats, patch_hw):
        rn = self.rn(self.levels(feats, patch_hw))
        p4 = self.refinenet4(rn[3], out_hw=rn[2].shape[1:3])
        p3 = self.refinenet3(p4, rn[2], out_hw=rn[1].shape[1:3])
        return self.final(p3, rn[1], rn[0], patch_hw)
