"""Depth backend factory (counterpart of ``nunif_tpu/iw3/depth/factory.py``).

Ported: the Depth-Anything v1/v2 table.  The other families (Video Depth
Anything, ZoeDepth, DepthPro, DA3, NULL) raise ``NotImplementedError``
naming ROADMAP queue 1.
"""
from __future__ import annotations

import torch

from .depth_anything import DepthAnythingModel, NAME_MAP as _DA_NAMES

DEPTH_MODEL_TYPES = list(_DA_NAMES)


def create_depth_model(model_type: str, device="cuda", dtype=torch.bfloat16):
    if DepthAnythingModel.supported(model_type):
        return DepthAnythingModel(model_type, device=device, dtype=dtype)
    raise NotImplementedError(
        f"depth model {model_type!r} is not ported to nunif_tpu_torch yet "
        "(ROADMAP queue 1; ported: Depth-Anything "
        f"{', '.join(DEPTH_MODEL_TYPES)})")
