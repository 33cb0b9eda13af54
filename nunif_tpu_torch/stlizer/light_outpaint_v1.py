"""``stlizer.light_outpaint_v1``: coarse border outpainting for the
stabilizer's ``--border outpaint`` (counterpart of
``nunif_tpu/stlizer/light_outpaint_v1.py``), NHWC.

Three stride-2 convs down to 1/8, window attention blocks (8 x 8 windows,
a learned score bias: ``WindowMHA2d`` / ``WindowScoreBias``) and pool
blocks (a local-contrast GLU MLP), a narrow U-shaped middle, a 1x1 conv to
RGB and a bilinear x8 upscale; the forward pass composites the prediction
into the masked borders.  fp32 (the input's dtype), flax paths as the JAX
module's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models import I2IBaseModel, register_model
from ..modules.attention import WindowMHA2d, WindowScoreBias
from ..modules.conv import leaky_relu
from ..modules.pad import crop2d, replication_pad2d
from ..modules.pool import avg_pool2d, max_pool2d
from ..modules.resize import resize


def _conv(x, layer):
    """An NHWC conv through its NCHW (channels_last) view."""
    return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _glu(h):
    a, b = h.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class PoolBlock(nn.Module):
    """x + MLP(avg_pool(x) - x): 1x1 conv, leaky ReLU 0.2, 3x3 depthwise
    conv (replicate padding), GLU, 1x1 conv."""

    def __init__(self, in_channels: int, kernel_size: int = 5):
        super().__init__()
        c = in_channels
        self.kernel_size = kernel_size
        self.mlp_0 = nn.Conv2d(c, c * 2, 1)
        self.mlp_3 = nn.Conv2d(c * 2, c * 2, 3, groups=c * 2)
        self.mlp_5 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        h = avg_pool2d(x, self.kernel_size) - x
        h = leaky_relu(_conv(h, self.mlp_0), 0.2)
        h = _glu(_conv(replication_pad2d(h, (1, 1, 1, 1)), self.mlp_3))
        return x + _conv(h, self.mlp_5)


class MHABlock(nn.Module):
    """x + window attention (8 x 8, learned score bias), then x + a GLU
    MLP of 1x1 convs."""

    def __init__(self, in_channels: int, window_size: int = 8, num_heads: int = 4):
        super().__init__()
        c = in_channels
        self.bias = WindowScoreBias((window_size, window_size))
        self.mha = WindowMHA2d(c, num_heads, (window_size, window_size))
        self.mlp_0 = nn.Conv2d(c, c * 2, 1)
        self.mlp_2 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        x = x + self.mha(x, attn_mask=self.bias())
        return x + _conv(_glu(_conv(x, self.mlp_0)), self.mlp_2)


class OutpaintBase(nn.Module):
    def __init__(self, dim: int = 64, window_size: int = 8):
        super().__init__()
        C, C2 = dim, dim // 2
        self.window_size = window_size
        cin = 4  # RGB and the mask
        for i, ch in enumerate((C // 8, C // 4, C)):
            setattr(self, f"dct_{i}", nn.Conv2d(cin, ch, 3, stride=2))
            cin = ch
        self.enc_mha = MHABlock(C, num_heads=C // 32)
        self.enc_pool = PoolBlock(C)
        self.proj_mid = nn.Conv2d(C, C2, 1)
        self.mid_mha1 = MHABlock(C2, num_heads=C2 // 32)
        self.mid_pool1 = PoolBlock(C2)
        self.mid_mha2 = MHABlock(C2, num_heads=C2 // 32)
        self.mid_pool2 = PoolBlock(C2)
        self.proj_out = nn.Conv2d(C2, C, 1)
        self.dec_mha = MHABlock(C, num_heads=C // 32)
        self.dec_pool = PoolBlock(C)
        self.to_image = nn.Conv2d(C, 3, 1)

    def forward(self, x, mask_f):
        h = torch.cat([x, mask_f.to(x.dtype)], dim=-1)
        for i in range(3):  # 1/2, 1/4, 1/8
            h = leaky_relu(_conv(replication_pad2d(h, (1, 1, 1, 1)),
                                 getattr(self, f"dct_{i}")), 0.2)
        h = self.enc_pool(self.enc_mha(h))
        m = _conv(h, self.proj_mid)
        m = self.mid_pool1(self.mid_mha1(m))
        m = self.mid_pool2(self.mid_mha2(m))
        h = h + _conv(m, self.proj_out)
        h = _conv(self.dec_pool(self.dec_mha(h)), self.to_image)
        return resize(h, h.shape[1] * self.window_size, h.shape[2] * self.window_size,
                      mode="bilinear", antialias=False)


@register_model
class LightOutpaintV1(I2IBaseModel):
    """forward(x (B, H, W, 3) with masked borders, mask (B, H, W, 1), 1 =
    outside) -> x with the borders outpainted, clipped to [0, 1]; with
    ``train`` (the composite before the clip, the net's output)."""
    model_name = "stlizer.light_outpaint_v1"
    i2i_scale = 1
    i2i_offset = 0
    i2i_blend_size = 0

    def __init__(self):
        super().__init__()
        self.net = OutpaintBase(64, 8)

    def forward(self, x, mask, train: bool = False):
        mod = 8 * 8
        B, H, W, _ = x.shape
        pad1 = (mod - W % mod) % mod
        pad2 = (mod - H % mod) % mod
        xp = replication_pad2d(x, (0, pad1, 0, pad2))
        mask_f = mask.to(x.dtype)
        if pad1 or pad2:
            mask_f = torch.nn.functional.pad(mask_f, (0, 0, 0, pad1, 0, pad2),
                                             value=1.0)
            xp = xp * (1 - mask_f)
        z = crop2d(self.net(xp, mask_f), (0, pad1, 0, pad2))
        mask3 = mask.to(z.dtype).expand_as(z)
        out = x.to(z.dtype) * (1 - mask3) + z * mask3
        if train:
            return out, z
        return torch.clamp(out, 0.0, 1.0)


@torch.no_grad()
def outpaint_infer(model, x, mask, max_size: int = 640):
    """Outpaint x's masked borders with the net run at <= ``max_size`` on
    the long side, composited at full resolution."""
    H, W = x.shape[1:3]
    if max(H, W) <= max_size:
        return model(x, mask)
    if H > W:
        nh, nw = max_size, round(W * (max_size / H))
    else:
        nh, nw = round(H * (max_size / W)), max_size
    xs = resize(x, nh, nw, mode="bilinear", antialias=False)
    ms = resize(mask.to(x.dtype), nh, nw, mode="bilinear", antialias=False)
    ms = (max_pool2d(ms, 3) > 0.5).to(x.dtype)
    z = model(xs * (1 - ms), ms)
    z = resize(z, H, W, mode="bilinear", antialias=False)
    mask3 = mask.to(z.dtype).expand_as(z)
    return torch.clamp(x * (1 - mask3) + z * mask3, 0.0, 1.0)
