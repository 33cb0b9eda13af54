"""sbs.row_flow_v3, the learned horizontal delta-warp net (counterpart of
``nunif_tpu/iw3/models/row_flow_v3.py``), NHWC, delta-output inference.

The (1, 8) pixel unshuffle keeps rows whole, two window-attention blocks
mix the packed columns, and a replication-padded 3x3 head gives the
per-pixel delta.  Plain PyTorch, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import I2IBaseModel, register_model, to_flax
from ...modules.attention import WindowMHA2d, WindowScoreBias
from ...modules.conv import leaky_relu
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_shuffle2, pixel_unshuffle2
from ..depth.dpt import conv

OFFSET = 32


class WABlock(nn.Module):
    """x + window attention with a learned score bias, then x + a 1x1
    GELU, replication-padded 3x3, leaky-ReLU conv MLP."""

    def __init__(self, in_channels: int, window_size, shift=(False, False),
                 num_heads: int = 2):
        super().__init__()
        self.bias = WindowScoreBias(window_size)
        self.mha = WindowMHA2d(in_channels, num_heads=num_heads,
                               window_size=window_size, shift=shift)
        self.conv_mlp_0 = nn.Conv2d(in_channels, in_channels, 1)
        self.conv_mlp_3 = nn.Conv2d(in_channels, in_channels, 3)

    def forward(self, x):
        x = x + self.mha(x, attn_mask=self.bias())
        h = F.gelu(conv(x, self.conv_mlp_0))
        h = conv(replication_pad2d(h, (1, 1, 1, 1)), self.conv_mlp_3)
        return x + leaky_relu(h, 0.1)


@register_model
class RowFlowV3(I2IBaseModel):
    model_name = "sbs.row_flow_v3"
    i2i_scale = 1
    i2i_offset = OFFSET
    i2i_blend_size = 4
    i2i_in_channels = 8

    def __init__(self, symmetric: bool = False, delta_output: bool = True):
        super().__init__()
        if not delta_output:
            raise NotImplementedError(
                "row_flow_v3 with delta_output=False: no training head warps "
                "inside the net in either package (the JAX flag is never "
                "read); the sbs trainer warps by the delta in its loss")
        self.symmetric = symmetric
        self.delta_output = delta_output
        self.blocks_0 = nn.Conv2d(3 * 8, 64, 1)
        self.blocks_1 = WABlock(64, (4, 4))
        self.blocks_2 = WABlock(64, (3, 3))
        self.last_layer_1 = nn.Conv2d(8, 1, 3)

    def forward(self, x, train: bool = False):
        """x (B, H, W, 3): the packed [depth, divergence_feat,
        convergence_feat] input -> delta (B, H, W, 1)."""
        df = (1, 8)
        mod = 4 * 3
        B, H, W, _ = x.shape
        pad1 = (mod * df[1]) - W % (mod * df[1])
        pad2 = (mod * df[0]) - H % (mod * df[0])
        h = pixel_unshuffle2(replication_pad2d(x, (0, pad1, 0, pad2)), df)
        h = conv(h, self.blocks_0)
        h = self.blocks_2(self.blocks_1(h))
        h = crop2d(pixel_shuffle2(h, df), (0, pad1, 0, pad2))
        return conv(replication_pad2d(h, (1, 1, 1, 1)), self.last_layer_1)


def shaped_flax_params(model: RowFlowV3, seed: int) -> dict:
    """Seeded random weights in flax layout (numpy, shared by both
    packages) under which the warp moves pixels.

    Base draw: lecun-normal kernels clipped at 2 std, N(0, 0.02) biases.
    ``last_layer_1/kernel`` is then scaled by 10: at the plain draw the
    delta's std is about 0.3 depth-map pixels and the warp hardly moves
    anything; scaled, it is about 3 (the warp rescales it to the frame
    width, so about 8 pixels at 1080p from a 686-wide depth map, clipped
    at the 28-pixel bound).
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.rsplit("/", 1)[-1] == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
            if key == "last_layer_1/kernel":
                a = a * 10.0
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
        flat[key] = a.astype(np.float32)
    return flat
