"""inpaint.light_inpaint_v1, the disocclusion inpainting net (counterpart
of ``nunif_tpu/iw3/models/light_inpaint_v1.py``), NHWC.

A pixel-unshuffle(4) patch embed with a learned token for masked patches,
a gMLP U-net (window 16 at C = 96, window 8 at C = 192), a pixel-shuffle
head, and the masked composite with the source.  Plain PyTorch, as the JAX
package leaves it to XLA.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import I2IBaseModel, register_model, to_flax
from ...modules.attention import WindowGMLP2d
from ...modules.conv import leaky_relu
from ...modules.norm import LayerNormNoBias
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_shuffle, pixel_unshuffle
from ..depth.dpt import conv
from ..dilation import dilate_inner, dilate_outer, mask_closing


def _gaussian_kernel1d(k: int) -> np.ndarray:
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k) - (k - 1) / 2
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def gaussian_blur2d(x, kernel_size: int = 15):
    """Separable Gaussian per channel, zero-padded, in fp32; x's dtype out."""
    C = x.shape[-1]
    pad = kernel_size // 2
    k = torch.from_numpy(_gaussian_kernel1d(kernel_size)).to(x.device)
    y = x.float().permute(0, 3, 1, 2)
    y = F.conv2d(y, k.reshape(1, 1, -1, 1).expand(C, 1, -1, 1),
                 padding=(pad, 0), groups=C)
    y = F.conv2d(y, k.reshape(1, 1, 1, -1).expand(C, 1, 1, -1),
                 padding=(0, pad), groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class GLUConvMLP(nn.Module):
    """1x1 conv to 2 * mid, a * sigmoid(b), replication-padded k x k conv
    (flax paths ``w1``, ``w2``)."""

    def __init__(self, out_channels: int, kernel_size: int = 3,
                 mlp_ratio: int = 2):
        super().__init__()
        mid = int(out_channels * mlp_ratio)
        self.kernel_size = kernel_size
        self.w1 = nn.Conv2d(out_channels, mid, 1)
        self.w2 = nn.Conv2d(mid // 2, out_channels, kernel_size)

    def forward(self, x):
        a, b = conv(x, self.w1).chunk(2, dim=-1)
        p = (self.kernel_size - 1) // 2
        return conv(replication_pad2d(a * torch.sigmoid(b), (p, p, p, p)),
                    self.w2)


class GMLPBlock(nn.Module):
    """x + WindowGMLP2d(x) with scale-only norms, then x + GLUConvMLP(x)."""

    def __init__(self, in_channels: int, window_size: int, mlp_ratio: int = 2,
                 shift: bool = False):
        super().__init__()
        self.norm1 = LayerNormNoBias(in_channels)
        self.norm2 = LayerNormNoBias(in_channels * mlp_ratio)
        self.gmlp = WindowGMLP2d(in_channels, window_size, mlp_ratio=mlp_ratio,
                                 shift=shift)
        self.glu_conv = GLUConvMLP(in_channels, mlp_ratio=1)

    def forward(self, x):
        x = x + self.gmlp(x, self.norm1, self.norm2)
        return x + self.glu_conv(x)


@register_model
class LightInpaintV1(I2IBaseModel):
    model_name = "inpaint.light_inpaint_v1"
    i2i_scale = 1
    i2i_offset = 16
    i2i_blend_size = 8

    def __init__(self):
        super().__init__()
        C, pack = 96, 16
        self.patch_0 = nn.Conv2d(3 * pack, C, 1)
        self.mask_bias = nn.Parameter(torch.zeros(1, 1, 1, C))
        self.enc1 = GMLPBlock(C, 16, shift=True)
        self.down = nn.Conv2d(C, C * 2, 2)
        for i, shift in enumerate((False, True, False, True)):
            self.add_module(f"enc2_{i}", GMLPBlock(C * 2, 8, shift=shift))
        self.up = nn.Conv2d(C * 2, C * 4, 1)
        self.dec1 = GMLPBlock(C, 16, shift=False)
        self.to_image_1 = nn.Conv2d(C, 3 * pack, 3)

    def forward(self, x, mask=None, train: bool = False,
                skip_i2i_offset: bool = True):
        """x (B, H, W, 3) masked image in [0, 1], mask (B, H, W, 1) ->
        the composite x * (1 - mask) + net * mask, clipped to [0, 1] unless
        ``train``."""
        if mask is None:
            raise ValueError("LightInpaintV1 needs a mask")
        df, mod = 4, 16
        src = x
        B, H, W, _ = x.shape
        pads = (0, mod * df - W % (mod * df), 0, mod * df - H % (mod * df))
        xp = replication_pad2d((x - 0.5) / 0.5, pads)
        m = replication_pad2d(mask, pads)
        h = leaky_relu(conv(pixel_unshuffle(xp, df), self.patch_0), 0.2)
        m_tok = pixel_unshuffle(m, df).amax(dim=-1, keepdim=True) > 0.99
        h = torch.where(m_tok, self.mask_bias.to(h.dtype), h)
        h1 = self.enc1(h)
        h2 = conv(h1, self.down, stride=2)
        for i in range(4):
            h2 = getattr(self, f"enc2_{i}")(h2)
        h2 = pixel_shuffle(conv(h2, self.up), 2)
        h = self.dec1(h1 + h2)
        h = conv(replication_pad2d(h, (1, 1, 1, 1)), self.to_image_1)
        out = crop2d(pixel_shuffle(h, df), pads)
        m = crop2d(m, pads)
        if not skip_i2i_offset:
            off = (self.i2i_offset,) * 4
            src, m, out = crop2d(src, off), crop2d(m, off), crop2d(out, off)
        composed = src * (1 - m) + out * m
        return composed if train else composed.clamp(0.0, 1.0)


def inpaint_preprocess(x, mask, closing=False, inner_dilation=0,
                       outer_dilation=0, base_width=None):
    """Close and dilate the mask, black out its pixels, and widen it by a
    15-tap Gaussian: (x, mask) for the net."""
    mask = mask_closing(mask) if closing else mask.float()
    mask = dilate_inner(mask, n_iter=inner_dilation, base_width=base_width)
    mask = dilate_outer(mask, n_iter=outer_dilation, base_width=base_width)
    x = x * (1 - mask)
    mask = (gaussian_blur2d(mask, 15) + mask).clamp(0.0, 1.0)
    return x, mask


@torch.no_grad()
def inpaint_infer(model, x, mask, closing=False, inner_dilation=0,
                  outer_dilation=0, base_width=None):
    """``inpaint_preprocess`` then the net: the inpainted frames."""
    x, mask = inpaint_preprocess(x, mask, closing=closing,
                                 inner_dilation=inner_dilation,
                                 outer_dilation=outer_dilation,
                                 base_width=base_width)
    return model(x, mask=mask, skip_i2i_offset=True)


RESIDUAL_SCALE = 0.25


def shaped_flax_params(model: LightInpaintV1, seed: int,
                       head=("to_image_1/kernel", 1 / 64)) -> dict:
    """Seeded random weights in flax layout (numpy, shared by both
    packages) under which every layer of the net acts.

    Base draw: lecun-normal kernels clipped at 2 std, N(0, 0.02) biases,
    LayerNorm scales N(1, 0.1).  Two leaves differ from flax's init, which
    would leave them inert: ``proj_spatial_kernel`` (flax: uniform below
    2e-3 / C, so W v ~ 0 and the gate is its bias alone) is drawn like a
    dense kernel over the window's N tokens, and ``mask_bias`` (flax:
    truncated normal at 0.01) at std 1, so that masked patches differ
    from the rest.  Each gMLP block adds its input twice (``GMLP`` returns
    its own residual and the block adds x again), so the stream doubles a
    block, and at the plain draw grows ~2.7x a block with fp32 rounding
    growing with it (0.12 at the output against float64).  The kernels
    that end each residual branch (gMLP's ``proj_out``, the GLU MLP's
    ``w2``) are scaled by ``RESIDUAL_SCALE`` (growth ~2.1x a block, 4.5e-4
    at an output of std 42), and the head ``to_image_1`` by 1/64 for the
    six blocks' doubling, so the net's output is of the image's order
    (``head``: (its flax path, its scale)).
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("kernel", "proj_spatial_kernel"):
            fan_in = math.prod(ref.shape[:-1])
            std = math.sqrt(1.0 / fan_in) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
            if key.endswith(("proj_out/kernel", "w2/kernel")):
                a = a * RESIDUAL_SCALE
            elif key == head[0]:
                a = a * head[1]
        elif leaf == "scale":
            a = rng.normal(1.0, 0.1, ref.shape)
        elif leaf == "mask_bias":
            a = rng.normal(0.0, 1.0, ref.shape)
        elif leaf == "proj_spatial_bias":
            a = rng.normal(1.0, 0.02, ref.shape)
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
        flat[key] = a.astype(np.float32)
    return flat
