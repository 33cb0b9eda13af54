"""sbs.row_flow_v2, the row-conv horizontal delta-warp net (counterpart of
``nunif_tpu/iw3/models/row_flow_v2.py``), NHWC, delta-output inference:
a 1x3 feature conv, a 1x1 head and a residual stack of 1x9 row convs and a
3x3, summed.  Plain PyTorch."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...models import I2IBaseModel, register_model, to_flax
from ...modules.pad import replication_pad2d
from ..depth.dpt import conv


@register_model
class RowFlowV2(I2IBaseModel):
    model_name = "sbs.row_flow_v2"
    i2i_scale = 1
    i2i_offset = 28
    i2i_blend_size = 4
    i2i_in_channels = 8

    def __init__(self, symmetric: bool = False, delta_output: bool = True):
        super().__init__()
        if not delta_output:
            raise NotImplementedError(
                "row_flow_v2 with delta_output=False (the training-time "
                "warping head) is not ported to nunif_tpu_torch yet")
        self.symmetric = symmetric
        self.delta_output = delta_output
        self.feature_0 = nn.Conv2d(3, 16, (1, 3))
        self.non_overlap = nn.Conv2d(16, 1, 1)
        self.overlap_residual_0 = nn.Conv2d(16, 16, (1, 9))
        self.overlap_residual_2 = nn.Conv2d(16, 32, (1, 9))
        self.overlap_residual_4 = nn.Conv2d(32, 32, (1, 9))
        self.overlap_residual_6 = nn.Conv2d(32, 1, 3)

    def forward(self, x, train: bool = False):
        """x (B, H, W, 3): the packed [depth, divergence_feat,
        convergence_feat] input -> delta (B, H, W, 1)."""
        h = torch.relu(conv(replication_pad2d(x, (1, 1, 0, 0)), self.feature_0))
        non_overlap = conv(h, self.non_overlap)
        r = h
        for layer in (self.overlap_residual_0, self.overlap_residual_2,
                      self.overlap_residual_4):
            r = torch.relu(conv(replication_pad2d(r, (4, 4, 0, 0)), layer))
        r = conv(replication_pad2d(r, (1, 1, 1, 1)), self.overlap_residual_6)
        return non_overlap + r


def shaped_flax_params(model: RowFlowV2, seed: int) -> dict:
    """Seeded random weights in flax layout (numpy, shared by both
    packages) under which the warp moves pixels.

    Base draw: lecun-normal kernels clipped at 2 std, N(0, 0.02) biases.
    The two heads' kernels (``non_overlap``, ``overlap_residual_6``) are
    then scaled by 100, as ``row_flow_v3.shaped_flax_params`` scales its
    head: at the plain draw the delta's std is about 0.03 depth-map
    pixels; scaled, about 3.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.rsplit("/", 1)[-1] == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
            if key in ("non_overlap/kernel", "overlap_residual_6/kernel"):
                a = a * 100.0
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
        flat[key] = a.astype(np.float32)
    return flat
