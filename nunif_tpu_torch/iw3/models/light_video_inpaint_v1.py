"""inpaint.light_video_inpaint_v1, the temporal disocclusion inpainting net
(counterpart of ``nunif_tpu/iw3/models/light_video_inpaint_v1.py``), NHWC.

The gMLP U-net of ``light_inpaint_v1`` with a strided 4x4 patch conv, and
at level 2 two temporal ``GMLP3DBlock``s (a gMLP over the 12 frames of the
clip at each token) between the spatial blocks.  ``video_inpaint_infer``
edge-pads a clip to a multiple of ``SEQ_LEN`` frames, half before and half
after.  Plain PyTorch, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
from torch import nn

from ...models import I2IBaseModel, register_model, register_model_factory
from ...modules.attention import WindowGMLP3d
from ...modules.conv import leaky_relu
from ...modules.norm import LayerNormNoBias
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_shuffle, pixel_unshuffle
from ..depth.dpt import conv
from . import light_inpaint_v1
from .light_inpaint_v1 import GLUConvMLP, GMLPBlock, inpaint_preprocess

SEQ_LEN = 12  # frames in a clip


class GMLP3DBlock(nn.Module):
    """x + WindowGMLP3d over the frame axis (x's batch axis is the clip's
    frames), then x + GLUConvMLP(x)."""

    def __init__(self, in_channels: int, window_size, mlp_ratio: int = 2,
                 shift: bool = False):
        super().__init__()
        self.norm1 = LayerNormNoBias(in_channels)
        self.norm2 = LayerNormNoBias(in_channels * mlp_ratio)
        self.gmlp = WindowGMLP3d(in_channels, window_size, mlp_ratio=mlp_ratio,
                                 shift=shift)
        self.glu_conv = GLUConvMLP(in_channels, mlp_ratio=1)

    def forward(self, x):
        x = x + self.gmlp(x[None], self.norm1, self.norm2)[0]
        return x + self.glu_conv(x)


@register_model
class LightVideoInpaintV1(I2IBaseModel):
    model_name = "inpaint.light_video_inpaint_v1"
    i2i_scale = 1
    i2i_offset = 16
    i2i_blend_size = 8

    def __init__(self, base_dim: int = 96, lv2_mlp_ratio: int = 1):
        super().__init__()
        self.base_dim = base_dim
        self.lv2_mlp_ratio = lv2_mlp_ratio
        C, C2, pack = base_dim, base_dim * 2, 16
        self.patch = nn.Conv2d(3, C, 4)
        self.mask_bias = nn.Parameter(torch.zeros(1, 1, 1, C))
        self.enc1 = GMLPBlock(C, 16, mlp_ratio=2, shift=False)
        self.down = nn.Conv2d(C, C2, 2)
        # level 2: [2D shift, 3D, 2D, 3D, 2D shift]
        self.enc2_0 = GMLPBlock(C2, 8, mlp_ratio=lv2_mlp_ratio, shift=True)
        self.enc2_1 = GMLP3DBlock(C2, (SEQ_LEN, 1, 1), mlp_ratio=2)
        self.enc2_2 = GMLPBlock(C2, 8, mlp_ratio=lv2_mlp_ratio, shift=False)
        self.enc2_3 = GMLP3DBlock(C2, (SEQ_LEN, 1, 1), mlp_ratio=2)
        self.enc2_4 = GMLPBlock(C2, 8, mlp_ratio=lv2_mlp_ratio, shift=True)
        self.up = nn.Conv2d(C2, C * 4, 1)
        self.dec1 = GMLPBlock(C, 16, mlp_ratio=2, shift=False)
        self.to_image = nn.Conv2d(C, 3 * pack, 1)

    def forward(self, x, mask=None, train: bool = False,
                skip_i2i_offset: bool = True):
        """x (SEQ_LEN, H, W, 3) masked clip in [0, 1], mask (SEQ_LEN, H, W,
        1) -> the composite x * (1 - mask) + net * mask, clipped to [0, 1]
        unless ``train``."""
        if mask is None:
            raise ValueError("LightVideoInpaintV1 needs a mask")
        if x.shape[0] != SEQ_LEN:
            raise ValueError(f"a clip holds {SEQ_LEN} frames, got {x.shape[0]}")
        df, mod = 4, 16
        src = x
        _B, H, W, _ = x.shape
        pads = (0, mod * df - W % (mod * df), 0, mod * df - H % (mod * df))
        xp = replication_pad2d((x - 0.5) / 0.5, pads)
        m = replication_pad2d(mask, pads)
        h = leaky_relu(conv(xp, self.patch, stride=df), 0.1)
        m_tok = pixel_unshuffle(m, df).amax(dim=-1, keepdim=True) > 0.99
        h = torch.where(m_tok, self.mask_bias.to(h.dtype), h)
        h1 = self.enc1(h)
        h2 = conv(h1, self.down, stride=2)
        for i in range(5):
            h2 = getattr(self, f"enc2_{i}")(h2)
        h2 = pixel_shuffle(conv(h2, self.up), 2)
        h = self.dec1(h1 + h2)
        out = crop2d(pixel_shuffle(conv(h, self.to_image), df), pads)
        m = crop2d(m, pads)
        if not skip_i2i_offset:
            off = (self.i2i_offset,) * 4
            src, m, out = crop2d(src, off), crop2d(m, off), crop2d(out, off)
        composed = src * (1 - m) + out * m
        return composed if train else composed.clamp(0.0, 1.0)


@register_model
class LightVideoInpaintV1Medium(LightVideoInpaintV1):
    model_name = "inpaint.light_video_inpaint_v1_medium"

    def __init__(self, base_dim: int = 128, lv2_mlp_ratio: int = 2):
        super().__init__(base_dim=base_dim, lv2_mlp_ratio=lv2_mlp_ratio)


@register_model
class LightVideoInpaintV1Large(LightVideoInpaintV1):
    model_name = "inpaint.light_video_inpaint_v1_large"

    def __init__(self, base_dim: int = 192, lv2_mlp_ratio: int = 2):
        super().__init__(base_dim=base_dim, lv2_mlp_ratio=lv2_mlp_ratio)


register_model_factory("inpaint.light_video_inpaint_v1_small", LightVideoInpaintV1)


@torch.no_grad()
def video_inpaint_infer(model, x, mask, closing=False, inner_dilation=0,
                        outer_dilation=0, base_width=None):
    """Edge-pad the clip (B, H, W, 3) to a multiple of ``SEQ_LEN`` frames,
    half the padding before it and half after, run ``inpaint_preprocess``
    and the net on each clip of ``SEQ_LEN``, and drop the padding."""
    B = x.shape[0]
    pad = (SEQ_LEN - B % SEQ_LEN) % SEQ_LEN
    before, after = pad // 2, pad - pad // 2

    def edge_pad(t):
        return torch.cat([t[:1].expand(before, *t.shape[1:]), t,
                          t[-1:].expand(after, *t.shape[1:])], dim=0)
    if pad:
        x, mask = edge_pad(x), edge_pad(mask)
    outs = []
    for i in range(0, x.shape[0], SEQ_LEN):
        xi, mi = inpaint_preprocess(x[i:i + SEQ_LEN], mask[i:i + SEQ_LEN],
                                    closing=closing,
                                    inner_dilation=inner_dilation,
                                    outer_dilation=outer_dilation,
                                    base_width=base_width)
        outs.append(model(xi, mask=mi, skip_i2i_offset=True))
    return torch.cat(outs, dim=0)[before:before + B]


def shaped_flax_params(model: LightVideoInpaintV1, seed: int) -> dict:
    """Seeded random weights in flax layout under which every layer acts:
    ``light_inpaint_v1.shaped_flax_params``'s draw (the temporal gMLPs'
    ``proj_spatial_kernel`` drawn like a dense kernel over the clip's 12
    frames, so each frame's tokens mix with the others'), with the head
    ``to_image`` scaled by 1/128 for the seven blocks' doubling."""
    return light_inpaint_v1.shaped_flax_params(
        model, seed, head=("to_image/kernel", 1 / 128))
