"""Forward warp plus learned inpainting of the disocclusions (counterpart
of ``nunif_tpu/iw3/forward_inpaint.py``): both eyes forward-warped with
their hole masks, the masks closed and grown, the holes filled by
``inpaint.light_inpaint_v1``, a right-view net, so the left eye runs
flipped."""
from __future__ import annotations

import torch

from ..modules.resize import resize
from .dilation import dilate_inner, dilate_outer, mask_closing
from .forward_warp import apply_divergence_forward_warp
from .models.light_inpaint_v1 import inpaint_infer


def _inpaint_side(model, eye, mask, inner_dilation, outer_dilation,
                  base_width, flip: bool):
    if flip:
        eye = eye.flip(2)
        mask = mask.flip(2)
    mask = mask_closing((mask > 0).float())
    mask = dilate_outer(mask, n_iter=outer_dilation, base_width=base_width)
    mask = dilate_inner(mask, n_iter=inner_dilation, base_width=base_width)
    eye = inpaint_infer(model, eye, mask)
    return eye.flip(2) if flip else eye


class ForwardInpaint:
    """The ``forward_inpaint`` method's side model: ``infer`` takes what
    ``pipeline.apply_divergence`` passes; ``model`` is a
    ``LightInpaintV1`` on the frames' device."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def infer(self, x, depth, divergence, convergence, synthetic_view="both",
              inner_dilation=0, outer_dilation=0, max_width=None, **kwargs):
        """x (B, H, W, 3), depth (B, h, w, 1) -> (left, right); frames
        wider than ``max_width`` are first downscaled to it (bilinear)."""
        if max_width is not None and x.shape[2] > max_width:
            max_width += max_width % 2
            new_h = int((max_width / x.shape[2]) * x.shape[1])
            new_h += new_h % 2
            x = resize(x, new_h, max_width, mode="bilinear", antialias=True)
        left, right, lmask, rmask = apply_divergence_forward_warp(
            x, depth, divergence, convergence, synthetic_view=synthetic_view,
            return_mask=True, width_base=False)
        kw = dict(inner_dilation=inner_dilation, outer_dilation=outer_dilation,
                  base_width=depth.shape[2])
        if synthetic_view in ("both", "left"):
            left = _inpaint_side(self.model, left, lmask, flip=True, **kw)
        if synthetic_view in ("both", "right"):
            right = _inpaint_side(self.model, right, rmask, flip=False, **kw)
        return left, right

    def flush(self, **kwargs):
        return None, None
