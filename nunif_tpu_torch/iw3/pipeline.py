"""iw3 image pipeline: preprocess -> depth -> divergence -> composition,
NHWC float in [0, 1] (counterpart of ``nunif_tpu/iw3/pipeline.py``).

Methods: the NN warps (``row_flow_v3``, ``row_flow_v2``, ``mlbw_*``: the
side model a checkpoint names), ``grid_sample`` / ``backward``, the forward
warps ``forward`` / ``forward_fill``, the inpaint methods
``forward_inpaint`` / ``mlbw_l2_inpaint`` / ``mlbw_l2_inpaint_video``
(the side model is a ``ForwardInpaint`` / ``MLBWInpaint`` /
``MLBWInpaintVideo``, which queues frames into clips and may return
``(None, None)``: ``video.Iw3FrameProcessor`` carries that) and ``NULL``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..modules.resize import resize
from .backward_warp import apply_divergence_grid_sample, apply_divergence_nn_LR
from .composition import StereoFormat, postprocess_image
from .forward_warp import apply_divergence_forward_warp
from .mapper import get_mapper, resolve_mapper_name

INPAINT_METHODS = ("forward_inpaint", "mlbw_l2_inpaint", "mlbw_l2_inpaint_video")


@dataclasses.dataclass
class StereoConfig:
    """The options that drive stereo generation."""
    method: str = "row_flow_v3"
    divergence: float = 2.0
    convergence: float = 0.5
    mapper: Optional[str] = None
    foreground_scale: float = 0
    synthetic_view: str = "both"   # both | right | left
    preserve_screen_border: bool = False
    warp_steps: Optional[int] = None
    stereo_width: Optional[int] = None
    # the inpaint methods' mask shaping and their frame-width cap
    mask_inner_dilation: int = 0
    mask_outer_dilation: int = 0
    inpaint_max_width: Optional[int] = None
    rotate_left: bool = False
    rotate_right: bool = False
    max_output_width: Optional[int] = None
    max_output_height: Optional[int] = None
    keep_aspect_ratio: bool = False
    format: StereoFormat = dataclasses.field(default_factory=StereoFormat)

    def resolved_mapper(self, metric_depth: bool) -> str:
        return resolve_mapper_name(self.mapper, self.foreground_scale,
                                   metric_depth=metric_depth)


def preprocess_image(x, cfg: StereoConfig):
    """Rotation and the max-height cap.  x (B, H, W, C)."""
    if cfg.rotate_left:
        x = torch.rot90(x, 1, dims=(1, 2))
    elif cfg.rotate_right:
        x = torch.rot90(x, 3, dims=(1, 2))
    H, W = x.shape[1:3]
    new_w, new_h = W, H
    if cfg.max_output_height is not None and new_h > cfg.max_output_height:
        new_w = int(cfg.max_output_height / new_h * new_w)
        new_h = cfg.max_output_height
    if (new_w, new_h) != (W, H):
        new_h -= new_h % 2
        new_w -= new_w % 2
        x = resize(x, new_h, new_w, mode="bicubic", antialias=True).clamp(0, 1)
    return x


def apply_divergence(depth, im, cfg: StereoConfig, side_model=None,
                     metric_depth: bool = False, convergence=None):
    """depth (B, h, w, 1) normalised, im (B, H, W, 3) -> (left, right).
    ``convergence``: an optional per-frame (B,) override."""
    mapper_fn = get_mapper(cfg.resolved_mapper(metric_depth))
    if convergence is None:
        convergence = cfg.convergence
    depth = mapper_fn(depth)
    if cfg.method == "NULL":
        return im, im
    if cfg.method in INPAINT_METHODS:
        if side_model is None:
            raise ValueError(f"method {cfg.method} needs an inpaint model")
        return side_model.infer(
            im, depth, cfg.divergence, convergence,
            synthetic_view=cfg.synthetic_view,
            inner_dilation=cfg.mask_inner_dilation,
            outer_dilation=cfg.mask_outer_dilation,
            max_width=cfg.inpaint_max_width)
    if cfg.method in ("grid_sample", "backward"):
        return apply_divergence_grid_sample(
            im, depth, cfg.divergence, convergence,
            synthetic_view=cfg.synthetic_view)
    if cfg.method in ("forward", "forward_fill"):
        return apply_divergence_forward_warp(
            im, depth, cfg.divergence, convergence, method=cfg.method,
            synthetic_view=cfg.synthetic_view, width_base=False)
    if cfg.stereo_width is not None:
        H, W = im.shape[1:3]
        stereo_width = min(W, cfg.stereo_width)
        if depth.shape[2] != stereo_width:
            new_h = int(H * (stereo_width / W))
            depth = resize(depth, new_h, stereo_width, mode="bilinear",
                           antialias=True).clamp(0, 1)
    if side_model is None:
        raise ValueError(f"method {cfg.method} needs a stereo model")
    return apply_divergence_nn_LR(
        side_model, im, depth, cfg.divergence, convergence,
        steps=cfg.warp_steps, synthetic_view=cfg.synthetic_view,
        preserve_screen_border=cfg.preserve_screen_border)


def resize_depth_for(depth, im, cfg: StereoConfig):
    """The plain backward warps need depth at frame resolution (the NN
    warps resize their deltas, the forward warps their depth)."""
    if cfg.method in ("grid_sample", "backward", "NULL") and \
            tuple(depth.shape[1:3]) != tuple(im.shape[1:3]):
        depth = resize(depth, im.shape[1], im.shape[2], mode="bilinear",
                       antialias=False).clamp(0, 1)
    return depth


@torch.no_grad()
def process_image(x, cfg: StereoConfig, depth_model, side_model=None,
                  tta=False, edge_dilation=0, return_depth=False):
    """x (B, H, W, 3) or (H, W, 3) in [0, 1] on the depth model's device ->
    the composed frame(s)."""
    batch = x.dim() == 4
    if not batch:
        x = x[None]
    x = preprocess_image(x, cfg)
    depth = depth_model.infer(x, tta=tta, edge_dilation=edge_dilation)
    normalized = depth_model.minmax_normalize(depth)
    if not normalized:
        raise ValueError("the depth scaler must have buffer_size 1 for images")
    depth = resize_depth_for(torch.stack(normalized, dim=0), x, cfg)
    left, right = apply_divergence(depth, x, cfg, side_model,
                                   metric_depth=depth_model.is_metric())
    if cfg.method == "mlbw_l2_inpaint_video":
        # a clip model: the frames it still queues come out of its flush
        rest = side_model.flush(inner_dilation=cfg.mask_inner_dilation,
                                outer_dilation=cfg.mask_outer_dilation)
        left, right = (a if b is None else b if a is None else torch.cat([a, b])
                       for a, b in zip((left, right), rest))
    out = postprocess_image(left, right, cfg.format)
    if not batch:
        out = out[0]
    return (out, depth) if return_depth else out
