"""iw3: 2D image/video to stereo 3D (counterpart of ``nunif_tpu/iw3``).

Ported: the frame path depth (Depth-Anything, Video Depth Anything,
ZoeDepth, DepthPro, Depth-Anything-V3 mono, NULL) -> EMA min-max normalisation
-> stereo (row_flow_v2 / v3, MLBW, the forward warps, forward or MLBW warp
plus inpainting, the plain backward warp) -> SBS/TB composition, driven by
``video.Iw3FrameProcessor`` and the image CLI.
"""
from . import models  # noqa: F401  (registers the iw3 nets)
from . import depth  # noqa: F401  (registers the depth nets)
