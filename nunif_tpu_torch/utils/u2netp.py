"""U2-Net-p salient object detection, NHWC (counterpart of
``nunif_tpu/utils/u2netp.py``).

Six stages of residual U-blocks (``RSU`` of height 7 down to 4, then the
dilated ``RSU4F``) with max-pool 2 / stride 2 (ceil mode) between them, a
mirrored decoder, six 3x3 side outputs resized to the input and fused by a
1x1 conv; every output is a sigmoid.  Each conv is a 3x3 (dilated) conv +
ReLU in x's dtype (BatchNorm is folded into the convs at conversion).
Resizes are bilinear without antialias, the port's ``modules/resize.py``
(the JAX package's matrices).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import cast_param
from ..models import Model, register_model
from ..modules.resize import resize


class _Conv(nn.Conv2d):
    """3x3 conv whose padding equals its dilation ("SAME"), NHWC in and
    out, in x's dtype."""

    def __init__(self, in_ch, out_ch, dilation=1, kernel_size=3):
        super().__init__(in_ch, out_ch, kernel_size, dilation=dilation,
                         padding=dilation * (kernel_size // 2))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), cast_param(self.weight, x.dtype),
                     cast_param(self.bias, x.dtype), padding=self.padding,
                     dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


def _rebnconv(conv, x):
    return F.relu(conv(x))


def _up_like(src, tar):
    return resize(src, tar.shape[1], tar.shape[2], mode="bilinear",
                  antialias=False)


def _pool_ceil(x):
    """MaxPool2d(2, stride 2, ceil_mode=True): an odd edge keeps its last
    row / column as a window of its own."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


class RSU(nn.Module):
    """Residual U-block of the given height (the reference's RSU7 / 6 / 5 /
    4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = _Conv(in_ch, out_ch)
        for i in range(1, height):
            setattr(self, f"rebnconv{i}", _Conv(out_ch if i == 1 else mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", _Conv(mid_ch, mid_ch, dilation=2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    _Conv(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x):
        hxin = _rebnconv(self.rebnconvin, x)
        enc = []
        h = hxin
        for i in range(1, self.height):
            h = _rebnconv(getattr(self, f"rebnconv{i}"), h)
            enc.append(h)
            if i < self.height - 1:
                h = _pool_ceil(h)
        h = _rebnconv(getattr(self, f"rebnconv{self.height}"), h)
        for i in range(self.height - 1, 0, -1):
            skip = enc[i - 1]
            if h.shape[1:3] != skip.shape[1:3]:
                h = _up_like(h, skip)
            h = _rebnconv(getattr(self, f"rebnconv{i}d"), torch.cat([h, skip], -1))
        return h + hxin


class RSU4F(nn.Module):
    """The dilated flat variant: dilations 1, 2, 4, 8 and back, no
    pooling."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = _Conv(in_ch, out_ch)
        self.rebnconv1 = _Conv(out_ch, mid_ch)
        self.rebnconv2 = _Conv(mid_ch, mid_ch, dilation=2)
        self.rebnconv3 = _Conv(mid_ch, mid_ch, dilation=4)
        self.rebnconv4 = _Conv(mid_ch, mid_ch, dilation=8)
        self.rebnconv3d = _Conv(2 * mid_ch, mid_ch, dilation=4)
        self.rebnconv2d = _Conv(2 * mid_ch, mid_ch, dilation=2)
        self.rebnconv1d = _Conv(2 * mid_ch, out_ch)

    def forward(self, x):
        hxin = _rebnconv(self.rebnconvin, x)
        h1 = _rebnconv(self.rebnconv1, hxin)
        h2 = _rebnconv(self.rebnconv2, h1)
        h3 = _rebnconv(self.rebnconv3, h2)
        h4 = _rebnconv(self.rebnconv4, h3)
        h3d = _rebnconv(self.rebnconv3d, torch.cat([h4, h3], -1))
        h2d = _rebnconv(self.rebnconv2d, torch.cat([h3d, h2], -1))
        h1d = _rebnconv(self.rebnconv1d, torch.cat([h2d, h1], -1))
        return h1d + hxin


@register_model
class U2NETP(Model):
    """(B, H, W, in_ch) -> (d0, ..., d6), fp32 sigmoid saliency maps at the
    input's size; d0 fuses the six side outputs."""
    model_name = "aux.u2netp"

    def __init__(self, in_ch: int = 6, out_ch: int = 1):
        super().__init__()
        self.in_ch = in_ch
        self.out_ch = out_ch
        self.stage1 = RSU(7, in_ch, 16, 64)
        self.stage2 = RSU(6, 64, 16, 64)
        self.stage3 = RSU(5, 64, 16, 64)
        self.stage4 = RSU(4, 64, 16, 64)
        self.stage5 = RSU4F(64, 16, 64)
        self.stage6 = RSU4F(64, 16, 64)
        self.stage5d = RSU4F(128, 16, 64)
        self.stage4d = RSU(4, 128, 16, 64)
        self.stage3d = RSU(5, 128, 16, 64)
        self.stage2d = RSU(6, 128, 16, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i in range(1, 7):
            setattr(self, f"side{i}", _Conv(64, out_ch))
        self.outconv = _Conv(6 * out_ch, out_ch, kernel_size=1)

    def forward(self, x, train: bool = False):
        hx1 = self.stage1(x)
        hx2 = self.stage2(_pool_ceil(hx1))
        hx3 = self.stage3(_pool_ceil(hx2))
        hx4 = self.stage4(_pool_ceil(hx3))
        hx5 = self.stage5(_pool_ceil(hx4))
        hx6 = self.stage6(_pool_ceil(hx5))
        hx5d = self.stage5d(torch.cat([_up_like(hx6, hx5), hx5], -1))
        hx4d = self.stage4d(torch.cat([_up_like(hx5d, hx4), hx4], -1))
        hx3d = self.stage3d(torch.cat([_up_like(hx4d, hx3), hx3], -1))
        hx2d = self.stage2d(torch.cat([_up_like(hx3d, hx2), hx2], -1))
        hx1d = self.stage1d(torch.cat([_up_like(hx2d, hx1), hx1], -1))
        sides = []
        for i, h in enumerate((hx1d, hx2d, hx3d, hx4d, hx5d, hx6), start=1):
            d = getattr(self, f"side{i}")(h)
            sides.append(_up_like(d, x) if h.shape[1:3] != x.shape[1:3] else d)
        d0 = self.outconv(torch.cat(sides, -1))
        return tuple(torch.sigmoid(d.float()) for d in [d0] + sides)
