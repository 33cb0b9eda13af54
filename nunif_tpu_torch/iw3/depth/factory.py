"""Depth backend factory (counterpart of ``nunif_tpu/iw3/depth/factory.py``).

Ported: Depth-Anything v1 / v2 and Video Depth Anything (windowed
``VDA_*``, streaming ``VDA_Stream_*``).  The other families (ZoeDepth,
DepthPro, DA3, MiDaS, NULL) raise ``NotImplementedError`` naming ROADMAP
queue 1.
"""
from __future__ import annotations

import torch

from .depth_anything import DepthAnythingModel, NAME_MAP as _DA_NAMES
from .vda import (NAME_MAP as _VDA_NAMES, STREAM_NAME_MAP as _VDA_STREAM_NAMES,
                  VideoDepthAnythingModel, VideoDepthAnythingStreamingModel)

DEPTH_MODEL_TYPES = list(_DA_NAMES) + list(_VDA_NAMES) + list(_VDA_STREAM_NAMES)


def create_depth_model(model_type: str, device="cuda", dtype=torch.bfloat16):
    for cls in (DepthAnythingModel, VideoDepthAnythingModel,
                VideoDepthAnythingStreamingModel):
        if cls.supported(model_type):
            return cls(model_type, device=device, dtype=dtype)
    raise NotImplementedError(
        f"depth model {model_type!r} is not ported to nunif_tpu_torch yet "
        "(ROADMAP queue 1; ported: Depth-Anything and Video Depth Anything: "
        f"{', '.join(DEPTH_MODEL_TYPES)})")
