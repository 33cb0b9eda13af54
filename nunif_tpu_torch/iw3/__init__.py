"""iw3: 2D image/video to stereo 3D (counterpart of ``nunif_tpu/iw3``).

Ported: the frame path Depth-Anything depth -> EMA min-max normalisation
-> row_flow_v3 (or the plain backward warp) -> SBS/TB composition, driven
by ``video.Iw3FrameProcessor`` and the image CLI.
"""
from . import models  # noqa: F401  (registers sbs.row_flow_v3)
from .depth import depth_anything  # noqa: F401  (registers iw3.depth_anything)
