"""The NULL depth model, for benchmarks and RGBD passthrough (counterpart of
``nunif_tpu/iw3/depth/null_model.py``): a square bilinear resize (no
antialias) to the resolution, the channel mean, the edge dilation.  No
network, no kernel."""
from __future__ import annotations

import torch

from ...modules.resize import resize
from ..dilation import dilate_edge, edge_dilation_is_enabled
from .base import BaseDepthModel


class NullDepthModel(BaseDepthModel):
    def __init__(self, model_type="NULL", device="cuda", dtype=torch.bfloat16):
        super().__init__(model_type, device=device, dtype=dtype)
        self.resolution = 392

    @classmethod
    def get_name(cls):
        return "NullDepth"

    @classmethod
    def supported(cls, model_type):
        return model_type == "NULL"

    def is_metric(self):
        return False

    def load_model(self, model_type, resolution=None, **kwargs):
        self.resolution = resolution or 392
        return "null"

    @torch.no_grad()
    def infer(self, x, tta=False, edge_dilation=0, **kwargs):
        """x (B, H, W, 3) or (H, W, 3) in [0, 1] -> (B, r, r, 1)."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        d = resize(x, self.resolution, self.resolution, mode="bilinear",
                   antialias=False)
        d = d.mean(dim=-1, keepdim=True)
        if edge_dilation_is_enabled(edge_dilation):
            d = dilate_edge(d, edge_dilation)
        return d if batch else d[0]
