"""cliqa predictor CNNs, NHWC (counterpart of ``nunif_tpu/cliqa/models.py``).

A replication pad, conv0 (VALID) and conv1, three 2 x 2 max pools around
two ``ResBlockCliqa``; each head a 3 x 3 conv, a max or mean over the
pixels and a 1 x 1 conv.  Every conv runs in x's dtype (flax
``nn.Conv(dtype=x.dtype)``).

Norm modes:
  * ``norm="gn"`` (default): flax's ``GroupNorm(32)`` (epsilon 1e-6)
    computed in fp32 and rounded once to x's dtype; the convs before a
    norm have no bias.
  * ``norm="none"``: no normalisation and every conv with a bias; reference
    checkpoints load this way, their eval-mode BatchNorm folded into the
    convs at conversion (``models/torch_convert.py:convert_cliqa``).

Parameter names follow the flax tree (``features/res1/gn1/GroupNorm_0/
scale``), so ``from_flax`` and ``.nztm`` files carry the weights across.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import dtypes  # noqa: F401  (TF32 off: fp32 means fp32 on the card)
from ..models import Model, register_model
from ..modules.conv import conv2d
from ..modules.norm import GroupNorm
from ..modules.pad import replication_pad2d


def _conv(x, layer, padding):
    """flax ``nn.Conv`` on NHWC x: ``padding`` 1 is SAME for 3 x 3."""
    return conv2d(x.permute(0, 3, 1, 2), layer, padding=padding).permute(0, 2, 3, 1)


class _Norm(nn.Module):
    """flax ``GroupNorm(32)`` in fp32 under its own scope (``GroupNorm_0``),
    or nothing for ``mode="none"``."""

    def __init__(self, channels: int, mode: str):
        super().__init__()
        if mode not in ("gn", "none"):
            raise ValueError(f"norm must be 'gn' or 'none', not {mode!r}")
        if mode == "gn":
            self.GroupNorm_0 = GroupNorm(32, channels, eps=1e-6)

    def forward(self, x):
        norm = getattr(self, "GroupNorm_0", None)
        return x if norm is None else norm(x)


class ResBlockCliqa(nn.Module):
    """relu(norm(conv2(relu(norm(conv1(x))))) + x)."""

    def __init__(self, channels: int, norm: str = "gn"):
        super().__init__()
        bias = norm == "none"
        self.conv1 = nn.Conv2d(channels, channels, 3, bias=bias)
        self.gn1 = _Norm(channels, norm)
        self.conv2 = nn.Conv2d(channels, channels, 3, bias=bias)
        self.gn2 = _Norm(channels, norm)

    def forward(self, x):
        h = torch.relu(self.gn1(_conv(x, self.conv1, 1)))
        h = self.gn2(_conv(h, self.conv2, 1))
        return torch.relu(h + x)


def _max_pool2(x):
    return torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _Trunk(nn.Module):
    def __init__(self, in_channels: int = 3, norm: str = "gn"):
        super().__init__()
        bias = norm == "none"
        self.conv0 = nn.Conv2d(in_channels, 64, 3, bias=bias)
        self.gn0 = _Norm(64, norm)
        self.conv1 = nn.Conv2d(64, 128, 3, bias=bias)
        self.gn1 = _Norm(128, norm)
        self.res1 = ResBlockCliqa(128, norm)
        self.res2 = ResBlockCliqa(128, norm)

    def forward(self, x):
        x = _conv(replication_pad2d(x, (1, 1, 1, 1)), self.conv0, 0)
        x = torch.relu(self.gn0(x))
        x = torch.relu(self.gn1(_conv(x, self.conv1, 1)))
        x = _max_pool2(self.res1(_max_pool2(x)))
        return _max_pool2(self.res2(x))


class _Head(nn.Module):
    def __init__(self, pool: str, norm: str = "gn"):
        super().__init__()
        self.pool = pool
        self.conv = nn.Conv2d(128, 256, 3, bias=norm == "none")
        self.gn = _Norm(256, norm)
        self.out = nn.Conv2d(256, 1, 1)

    def forward(self, x):
        x = torch.relu(self.gn(_conv(x, self.conv, 1)))
        if self.pool == "max":
            x = x.amax(dim=(1, 2), keepdim=True)
        else:
            x = x.mean(dim=(1, 2), keepdim=True)
        return _conv(x, self.out, 0).reshape(x.shape[0], -1)


class _Cliqa(Model):
    def __init__(self, norm: str = "gn"):
        super().__init__()
        self.norm = norm


@register_model
class JPEGQuality(_Cliqa):
    """(quality 0-100, chroma-subsampling logit), each (B, 1)."""
    model_name = "cliqa.jpeg_quality"

    def __init__(self, norm: str = "gn"):
        super().__init__(norm)
        self.features = _Trunk(6, norm)
        self.quality_output = _Head("max", norm)
        self.subsampling_output = _Head("avg", norm)

    @staticmethod
    def preprocess(x):
        """RGB in [0, 1] -> [Y, Cb, Cr, R, G, B] in [-1, 1]."""
        r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
        y = r * 0.299 + g * 0.587 + b * 0.114
        cb = (b - y) * 0.564 + 0.5
        cr = (r - y) * 0.713 + 0.5
        return torch.cat([y, cb, cr, r, g, b], dim=-1) * 2.0 - 1.0

    def forward(self, x, train: bool = False):
        h = self.features(self.preprocess(x))
        return self.quality_output(h), self.subsampling_output(h)


@register_model
class GrainNoiseLevel(_Cliqa):
    """noise level (0-50 = 50 - PSNR), (B, 1)."""
    model_name = "cliqa.grain_noise_level"

    def __init__(self, norm: str = "gn"):
        super().__init__(norm)
        self.features = _Trunk(3, norm)
        self.noise_level_output = _Head("max", norm)

    def forward(self, x, train: bool = False):
        return self.noise_level_output(self.features(x * 2.0 - 1.0))


@register_model
class ScaleFactor(_Cliqa):
    """pre-upscale factor (1.0-2.0), (B, 1)."""
    model_name = "cliqa.scale_factor"

    def __init__(self, norm: str = "gn"):
        super().__init__(norm)
        self.features = _Trunk(3, norm)
        self.scale_factor_output = _Head("max", norm)

    def forward(self, x, train: bool = False):
        return self.scale_factor_output(self.features(x * 2.0 - 1.0))
