"""MLBW warp plus learned inpainting of the disocclusion holes
(counterpart of ``nunif_tpu/iw3/mlbw_inpaint.py``): ``MLBWInpaint`` a
frame at a time, ``MLBWInpaintVideo`` in clips of 12 frames.

A mask-MLBW (``sbs.mlbw`` with a hole-mask head) warps each eye and
predicts its holes; the mask, thresholded at ``MASK_MLBW_THRESHOLD``, goes
with the eye through ``inpaint.light_inpaint_v1``, a right-view net, so
the left eye runs flipped.  The eyes run as two calls, as in JAX: four K3
launches a batch for the two-layer mask-MLBW.  The divergence stays a host
float, which keeps the warp on K3.  ``MLBWInpaintVideo`` warps each batch
at once and queues the warped eyes and masks until whole clips of
``SEQ_LEN`` frames are ready for ``inpaint.light_video_inpaint_v1``; its
``flush`` inpaints the rest as one edge-padded clip.
"""
from __future__ import annotations

import torch

from .backward_warp import (apply_divergence_nn_delta_weight,
                            postprocess_hole_mask)
from .models.light_inpaint_v1 import inpaint_infer
from .models.light_video_inpaint_v1 import SEQ_LEN, video_inpaint_infer
from .models.mlbw import MLBW

MASK_MLBW_THRESHOLD = 0.15


def make_mask_mlbw():
    """The hole-mask MLBW: two layers with a mask head (the
    ``iw3_mask_mlbw_l2_d1`` checkpoint's architecture)."""
    return MLBW(num_layers=2, hole_mask=True)


class MLBWInpaint:
    """The ``mlbw_l2_inpaint`` method's side model: ``infer`` takes what
    ``pipeline.apply_divergence`` passes.  ``inpaint_model`` is a
    ``LightInpaintV1``, ``mask_model`` a hole-mask MLBW, both on the
    frames' device."""

    def __init__(self, inpaint_model, mask_model):
        if not getattr(mask_model, "hole_mask", False):
            raise ValueError("MLBWInpaint: mask_model has no hole-mask head")
        self.inpaint_model = inpaint_model
        self.mask_model = mask_model

    def _warp(self, x, depth, divergence, convergence, synthetic_view,
              preserve_screen_border):
        def warp(div, shift):
            return apply_divergence_nn_delta_weight(
                self.mask_model, x, depth, float(div), convergence,
                shift=shift, preserve_screen_border=preserve_screen_border,
                return_mask=True)
        if synthetic_view == "both":
            (left, lmask), (right, rmask) = warp(divergence, -1), warp(divergence, 1)
        elif synthetic_view == "right":
            (left, lmask), (right, rmask) = (x, None), warp(divergence * 2, 1)
        else:
            (left, lmask), (right, rmask) = warp(divergence * 2, -1), (x, None)
        return left, lmask, right, rmask

    infer_fn = staticmethod(inpaint_infer)

    def _inpaint_side(self, eye, mask_logits, inner_dilation, outer_dilation,
                      flip):
        if flip:
            eye = eye.flip(2)
            mask_logits = mask_logits.flip(2)
        mask = postprocess_hole_mask(
            mask_logits, eye.shape[1:3], MASK_MLBW_THRESHOLD,
            inner_dilation=inner_dilation, outer_dilation=outer_dilation)
        eye = self.infer_fn(self.inpaint_model, eye, mask)
        return eye.flip(2) if flip else eye

    @torch.no_grad()
    def infer(self, x, depth, divergence, convergence, synthetic_view="both",
              preserve_screen_border=False, inner_dilation=0,
              outer_dilation=0, **kwargs):
        """x (B, H, W, 3), depth (B, h, w, 1) -> (left, right)."""
        if synthetic_view not in ("both", "right", "left"):
            raise ValueError(synthetic_view)
        left, lmask, right, rmask = self._warp(
            x, depth, divergence, convergence, synthetic_view,
            preserve_screen_border)
        if lmask is not None:
            left = self._inpaint_side(left, lmask, inner_dilation,
                                      outer_dilation, flip=True)
        if rmask is not None:
            right = self._inpaint_side(right, rmask, inner_dilation,
                                       outer_dilation, flip=False)
        return left, right

    def flush(self, **kwargs):
        return None, None


class MLBWInpaintVideo(MLBWInpaint):
    """The ``mlbw_l2_inpaint_video`` method's side model: ``inpaint_model``
    is a ``LightVideoInpaintV1``.  ``infer`` warps the batch, queues each
    frame's eyes and hole-mask logits, and returns (left, right) for every
    whole clip of ``SEQ_LEN`` queued frames, in order, or (None, None)
    while fewer are queued; ``flush`` returns the rest, inpainted as one
    clip edge-padded to ``SEQ_LEN``."""
    infer_fn = staticmethod(video_inpaint_infer)

    def __init__(self, inpaint_model, mask_model):
        super().__init__(inpaint_model, mask_model)
        self._queue = []  # (left, lmask, right, rmask) of one frame each

    def reset(self):
        self._queue = []

    def _drain(self, count, inner_dilation, outer_dilation):
        items, self._queue = self._queue[:count], self._queue[count:]
        left, lmask, right, rmask = (
            None if items[0][i] is None else torch.cat([it[i] for it in items])
            for i in range(4))
        if lmask is not None:
            left = self._inpaint_side(left, lmask, inner_dilation,
                                      outer_dilation, flip=True)
        if rmask is not None:
            right = self._inpaint_side(right, rmask, inner_dilation,
                                       outer_dilation, flip=False)
        return left, right

    @torch.no_grad()
    def infer(self, x, depth, divergence, convergence, synthetic_view="both",
              preserve_screen_border=False, inner_dilation=0,
              outer_dilation=0, **kwargs):
        if synthetic_view not in ("both", "right", "left"):
            raise ValueError(synthetic_view)
        warped = self._warp(x, depth, divergence, convergence, synthetic_view,
                            preserve_screen_border)
        for i in range(x.shape[0]):
            self._queue.append(tuple(None if t is None else t[i:i + 1]
                                     for t in warped))
        ready = len(self._queue) // SEQ_LEN * SEQ_LEN
        if not ready:
            return None, None
        return self._drain(ready, inner_dilation, outer_dilation)

    @torch.no_grad()
    def flush(self, inner_dilation=0, outer_dilation=0, **kwargs):
        if not self._queue:
            return None, None
        return self._drain(len(self._queue), inner_dilation, outer_dilation)
