"""Depth estimation backends (counterpart of ``nunif_tpu/iw3/depth``)."""
from .factory import DEPTH_MODEL_TYPES, create_depth_model  # noqa: F401
