"""Depth backend factory (counterpart of ``nunif_tpu/iw3/depth/factory.py``):
Depth-Anything v1 / v2, NULL, Video Depth Anything (windowed ``VDA_*``,
streaming ``VDA_Stream_*``), ZoeDepth (N / K / NK on the MiDaS BEiT core,
ZoeD_Any on Depth-Anything), DepthPro and Depth-Anything-V3 mono, in the
JAX package's order.
"""
from __future__ import annotations

import torch

from .da3 import NAME_MAP as _DA3_NAMES, DepthAnythingV3MonoModel
from .depth_anything import DepthAnythingModel, NAME_MAP as _DA_NAMES
from .depth_pro import NAME_MAP as _PRO_NAMES, DepthProModel
from .null_model import NullDepthModel
from .vda import (NAME_MAP as _VDA_NAMES, STREAM_NAME_MAP as _VDA_STREAM_NAMES,
                  VideoDepthAnythingModel, VideoDepthAnythingStreamingModel)
from .zoedepth import MODEL_TYPES as _ZOE_NAMES, ZoeDepthModel

DEPTH_MODEL_TYPES = (list(_DA_NAMES) + ["NULL"] + list(_VDA_NAMES)
                     + list(_VDA_STREAM_NAMES) + list(_ZOE_NAMES)
                     + list(_PRO_NAMES) + list(_DA3_NAMES))


def create_depth_model(model_type: str, device="cuda", dtype=torch.bfloat16,
                       **kwargs):
    """The wrapper of ``model_type`` on ``device`` with the network's
    compute dtype; ``kwargs`` go to the VDA and DA3 wrappers (``window_size``,
    ``raw_output``)."""
    for cls in (DepthAnythingModel, VideoDepthAnythingModel,
                VideoDepthAnythingStreamingModel, ZoeDepthModel, DepthProModel,
                DepthAnythingV3MonoModel, NullDepthModel):
        if cls.supported(model_type):
            extra = kwargs if cls in (VideoDepthAnythingModel,
                                      VideoDepthAnythingStreamingModel,
                                      DepthAnythingV3MonoModel) else {}
            return cls(model_type, device=device, dtype=dtype, **extra)
    raise ValueError(f"{model_type} is not supported")
