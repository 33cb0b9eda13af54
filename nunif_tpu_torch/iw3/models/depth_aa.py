"""iw3.depth_aa, the depth-map anti-aliasing net, NHWC (counterpart of
``nunif_tpu/iw3/models/depth_aa.py``).

Replication pad to a multiple of 16, pixel-unshuffle by 2, a 1x1
projection to 32 channels, three row_flow_v3 ``WABlock``s (8 x 8 windows,
shifted / not / shifted), a 1x1 projection to 4 channels (zero at flax's
init, so an untrained net is the identity), pixel-shuffle back, crop, and
the result added to the input.  Runs in x's dtype (fp32 on iw3's path,
as in the JAX package).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...models import I2IBaseModel, init_flax_default, register_model, to_flax
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_shuffle, pixel_unshuffle
from ..depth.dpt import conv
from .row_flow_v3 import WABlock


@register_model
class DepthAA(I2IBaseModel):
    model_name = "iw3.depth_aa"
    i2i_scale = 1
    i2i_offset = 0
    i2i_blend_size = 0

    def __init__(self):
        super().__init__()
        self.proj_in = nn.Conv2d(4, 32, 1)
        for i, shift in enumerate((True, False, True)):
            setattr(self, f"blocks_{i}",
                    WABlock(32, (8, 8), shift=(shift, shift), num_heads=2))
        self.proj_out = nn.Conv2d(32, 4, 1)

    def forward(self, x, train: bool = False, clamp=None):
        """x (B, H, W, 1) depth in [0, 1] -> (B, H, W, 1), clamped to [0,
        1] unless training (or ``clamp`` says otherwise)."""
        B, H, W, _ = x.shape
        pad_w, pad_h = 16 - W % 16, 16 - H % 16
        pads = (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)
        h = pixel_unshuffle(replication_pad2d(x, pads), 2)
        h = conv(h, self.proj_in)
        h = self.blocks_2(self.blocks_1(self.blocks_0(h)))
        h = crop2d(pixel_shuffle(conv(h, self.proj_out), 2), pads)
        y = x + h
        if (not train) if clamp is None else clamp:
            y = y.clamp(0.0, 1.0)
        return y

    def init_flax_default_(self, generator: torch.Generator):
        """flax's init: ``init_flax_default``, then ``proj_out``'s kernel
        zero (the JAX module's ``kernel_init``)."""
        init_flax_default(self, generator)
        with torch.no_grad():
            self.proj_out.weight.zero_()
        return self


@torch.no_grad()
def depth_aa_infer(model: DepthAA, x):
    """Normalise x by the min and max of the whole batch (not per frame),
    run the net unclamped, and map back."""
    min_v, max_v = x.amin(), x.amax()
    scale = (max_v - min_v).clamp(min=1e-12)
    y = model(torch.nan_to_num((x - min_v) / scale), clamp=False)
    return y * scale + min_v


def shaped_flax_params(model: DepthAA, seed: int) -> dict:
    """Seeded random weights in flax layout (numpy, shared by both
    packages) under which the net changes the depth: lecun-normal kernels
    clipped at 2 std, N(0, 0.02) biases, and ``proj_out`` drawn like any
    kernel but scaled by 0.1 (at flax's init it is zero and the net the
    identity)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.rsplit("/", 1)[-1] == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
            if key == "proj_out/kernel":
                a = a * 0.1
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
        flat[key] = a.astype(np.float32)
    return flat
