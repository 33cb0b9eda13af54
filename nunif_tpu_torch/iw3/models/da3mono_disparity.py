"""iw3.da3mono_disparity, the learned depth -> disparity conversion for
DA3 (counterpart of ``nunif_tpu/iw3/models/da3mono_disparity.py``).

64 sorted-quantile features of each depth map -> a 3-layer MLP -> (shift,
sky shift); the sky (the pixels at the map's maximum) gets the sky shift
added, then disparity = 1 / (depth + shift).  fp32, plain PyTorch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import I2IBaseModel, register_model
from ...utils.linspace import xla_linspace

FEAT_DIM = 64


@functools.lru_cache(maxsize=None)
def quantile_indexes(n: int) -> torch.Tensor:
    """The JAX module's ``linspace(1, n - 2, FEAT_DIM - 2).astype(int32)``,
    with the fp32 values its compiled program gives, truncated."""
    return torch.from_numpy(
        xla_linspace(1, n - 2, FEAT_DIM - 2).astype(np.int32).astype(np.int64))


def extract_features(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 1) -> (B, FEAT_DIM): the minimum, 62 interior
    quantiles and the maximum of each sorted map."""
    B = x.shape[0]
    flat = torch.sort(x.reshape(B, -1), dim=-1).values
    idx = quantile_indexes(flat.shape[-1]).to(flat.device)
    return torch.cat([flat[:, :1], flat[:, idx], flat[:, -1:]], dim=-1)


@register_model
class DA3MonoDisparity(I2IBaseModel):
    model_name = "iw3.da3mono_disparity"
    i2i_scale = 1
    i2i_offset = 0
    i2i_blend_size = 0

    def __init__(self):
        super().__init__()
        self.mlp_0 = nn.Linear(FEAT_DIM, 128)
        self.mlp_2 = nn.Linear(128, 128)
        self.mlp_4 = nn.Linear(128, 2)

    def forward(self, depth: torch.Tensor, train: bool = False) -> torch.Tensor:
        """depth (B, H, W, 1), a positive distance -> disparity (B, H, W, 1)."""
        h = F.silu(self.mlp_0(extract_features(
            depth.to(torch.promote_types(depth.dtype, torch.float32)))))
        h = F.silu(self.mlp_2(h))
        h = F.relu(self.mlp_4(h))
        shift = h[:, 0].reshape(-1, 1, 1, 1)
        sky_shift = h[:, 1].reshape(-1, 1, 1, 1)
        max_depth = torch.amax(depth, dim=(1, 2, 3), keepdim=True)
        depth = torch.where(depth == max_depth, depth + sky_shift, depth)
        return 1.0 / (depth + shift)
