"""sbs.mlbw, the multi-layer blended warp net (counterpart of
``nunif_tpu/iw3/models/mlbw.py``), NHWC, delta-output inference.

1x9 row convs around a trunk of window-attention blocks on (1, 8)
pixel-unshuffled features; the head gives ``num_layers`` deltas, their
softmax blend weights (fp32) and, with ``hole_mask``, one hole-mask logit.
Plain PyTorch, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import (I2IBaseModel, register_model, register_model_factory,
                       to_flax)
from ...modules.conv import leaky_relu
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_shuffle2, pixel_unshuffle2
from ..depth.dpt import conv
from . import row_flow_v3

OFFSET = 32


class WABlock(row_flow_v3.WABlock):
    """row_flow_v3's block without the trailing leaky-ReLU."""

    def forward(self, x):
        x = x + self.mha(x, attn_mask=self.bias())
        h = F.gelu(conv(x, self.conv_mlp_0))
        return x + conv(replication_pad2d(h, (1, 1, 1, 1)), self.conv_mlp_3)


@register_model
class MLBW(I2IBaseModel):
    model_name = "sbs.mlbw"
    i2i_scale = 1
    i2i_offset = OFFSET
    i2i_blend_size = 4
    i2i_in_channels = 8

    def __init__(self, num_layers: int = 2, base_dim: int = 32,
                 small: bool = False, cycle: bool = False,
                 hole_mask: bool = False, symmetric: bool = False,
                 delta_output: bool = True):
        super().__init__()
        if not delta_output:
            raise NotImplementedError(
                "mlbw with delta_output=False (the training-time warping "
                "head) is not ported to nunif_tpu_torch yet")
        self.num_layers = num_layers
        self.base_dim = base_dim
        self.small = small
        self.cycle = cycle
        self.hole_mask = hole_mask
        self.symmetric = symmetric
        self.delta_output = delta_output
        C = base_dim * num_layers
        if C < 8 or C // 8 < num_layers * 2:
            raise ValueError(f"mlbw: base_dim * num_layers = {C} too small")
        self.lv1_in_1 = nn.Conv2d(3, C // 8, (1, 9))
        shifts = ([(False, True), (False, False)] if small else
                  [(True, True), (False, False), (True, True), (False, False)])
        for i, shift in enumerate(shifts):
            self.add_module(f"lv2_{i}", WABlock(C, (4, 4), shift=shift,
                                                num_heads=num_layers))
        self.n_blocks = len(shifts)
        self.lv1_out_1 = nn.Conv2d(C // 8, num_layers * 2 + int(hole_mask),
                                   (1, 9))

    def forward(self, x, train: bool = False):
        """x (B, H, W, 3): the packed [depth, divergence_feat,
        convergence_feat] input -> (delta (B, H, W, L), layer weights (B,
        H, W, L) fp32[, hole-mask logits (B, H, W, 1)])."""
        df, mod = (1, 8), 4
        B, H, W, _ = x.shape
        pad_w = mod * df[1] - W % (mod * df[1])
        pad_h = mod * df[0] - H % (mod * df[0])
        pads = (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)
        h = replication_pad2d(replication_pad2d(x, pads), (4, 4, 0, 0))
        h = x1 = leaky_relu(conv(h, self.lv1_in_1), 0.2)
        h = pixel_unshuffle2(h, df)
        for i in range(self.n_blocks):
            h = getattr(self, f"lv2_{i}")(h)
        h = pixel_shuffle2(h, df) + x1
        h = conv(replication_pad2d(h, (4, 4, 0, 0)), self.lv1_out_1)
        h = crop2d(h, pads)
        L = self.num_layers
        delta = h[..., :L]
        layer_weight = torch.softmax(h[..., L:2 * L].float(), dim=-1)
        if self.hole_mask:
            return delta, layer_weight, h[..., 2 * L:]
        return delta, layer_weight


register_model_factory("sbs.mlbw_l2",
                       lambda **kw: MLBW(num_layers=2, base_dim=32, **kw))
register_model_factory("sbs.mlbw_l4",
                       lambda **kw: MLBW(num_layers=4, base_dim=32, **kw))
register_model_factory("sbs.mlbw_l2s",
                       lambda **kw: MLBW(num_layers=2, base_dim=32, small=True, **kw))
register_model_factory("sbs.mlbw_l4s",
                       lambda **kw: MLBW(num_layers=4, base_dim=32, small=True, **kw))
register_model_factory("sbs.mask_mlbw_l2",
                       lambda **kw: MLBW(num_layers=2, base_dim=32, hole_mask=True, **kw))


def shaped_flax_params(model: MLBW, seed: int) -> dict:
    """Seeded random weights in flax layout (numpy, shared by both
    packages) under which the blended warp moves pixels.

    Base draw: lecun-normal kernels clipped at 2 std, N(0, 0.02) biases.
    ``lv1_out_1/kernel`` is then scaled by 2: the deltas' std is then
    about 2-4 depth-map pixels (the warp rescales them to the frame width:
    ~10 pixels at 1080p from a 686-wide map, clipped at the 28-pixel
    bound) and the layer weights vary (std ~0.3-0.4, up to 0 and 1), where
    at 10 most deltas pass the bound and the weights are 0 or 1.  With
    ``hole_mask`` the hole logit's bias is set to -5, so that sigmoid(logit)
    > 0.15 (logit > -1.73) holds on a minority of the pixels (about 10% of
    a smooth depth map's), and not on about half as at bias 0.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.rsplit("/", 1)[-1] == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
            if key == "lv1_out_1/kernel":
                a = a * 2.0
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
            if key == "lv1_out_1/bias" and model.hole_mask:
                a[-1] = -5.0
        flat[key] = a.astype(np.float32)
    return flat
