"""iw3: 2D image/video to stereo 3D (counterpart of ``nunif_tpu/iw3``).

Ported: the frame path depth (Depth-Anything, Video Depth Anything,
ZoeDepth, DepthPro, Depth-Anything-V3 mono, NULL) -> EMA min-max normalisation
with the DepthAA filter -> EMA min-max normalisation -> the SOD
convergence estimator -> stereo (row_flow_v2 / v3, MLBW, the forward
warps, forward or MLBW warp plus inpainting, the plain backward warp) ->
SBS / TB / anaglyph / VR180 / RGBD composition or the debug depth, driven
by ``video.Iw3FrameProcessor`` (with letterbox crop) and the image CLI
(with export / import).
"""
from . import models  # noqa: F401  (registers the iw3 nets)
from . import depth  # noqa: F401  (registers the depth nets)
