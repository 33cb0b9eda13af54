"""stlizer, a conservative video stabilizer (counterpart of
``nunif_tpu/stlizer``): SuperPoint keypoints -> per-frame shift / angle ->
trajectory smoothing -> affine warp with a border policy, with an
md5-keyed analysis cache."""
from .pipeline import calc_scene_weight, stabilize_video
