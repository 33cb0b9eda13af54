"""Backward (gather) stereo warps, the learned row_flow delta warp and
MLBW's multi-layer blended warp, NHWC (counterpart of
``nunif_tpu/iw3/backward_warp.py``).

The stereo displacement is horizontal and bounded by the divergence, so
the warp is ``modules.grid_sample.warp_x_bounded`` (kernel K3 on CUDA)
wherever the bound is at most 128 pixels, and the gather ``warp_x``
beyond it.  The bound is taken from the divergence, a host float: MLBW
launches K3 once a layer.
"""
from __future__ import annotations

import math

import torch

from ..modules import grid_sample as _gs
from ..modules.resize import resize
from .dilation import dilate_inner, dilate_outer, mask_closing
from .mapper import get_mapper


def make_divergence_feature_value(divergence, convergence, image_width):
    divergence_pix = divergence * 0.5 * 0.01 * image_width
    divergence_feature_value = divergence_pix / 32.0
    convergence_feature_value = (-divergence_pix * convergence) / 32.0
    return divergence_feature_value, convergence_feature_value


def _border_ramp(feat, divergence, image_width):
    """Force screen-border parallax toward zero."""
    W = feat.shape[-1]
    border_pix = round(divergence * 0.75 * 0.01 * image_width * (W / image_width))
    if border_pix <= 0:
        return feat
    weight = torch.ones((W,), dtype=feat.dtype, device=feat.device)
    weight[:border_pix] = torch.linspace(0.0, 1.0, border_pix, dtype=feat.dtype)
    weight[W - border_pix:] = torch.linspace(1.0, 0.0, border_pix, dtype=feat.dtype)
    return feat * weight


def make_input_tensor(c, depth, divergence, convergence, image_width,
                      mapper=None, preserve_screen_border=False):
    """The NN-warp input, NHWC.  depth (B, H, W, 1).  With c=None returns
    (B, H, W, 3) [depth, divergence_feat, convergence_feat], the inference
    input; with c (B, H, W, 3) returns (B, H, W, 8) adding rgb and the
    identity grid (the training input)."""
    d = depth[..., 0]
    if mapper is not None:
        d = get_mapper(mapper)(d)
    B, H, W = d.shape
    div_v, conv_v = make_divergence_feature_value(divergence, convergence,
                                                  image_width)
    divergence_feat = torch.full_like(d, div_v)
    if torch.is_tensor(conv_v) and conv_v.dim():  # per-frame convergence (B,)
        convergence_feat = conv_v.to(d).reshape(B, 1, 1).expand(B, H, W)
    else:
        convergence_feat = torch.full_like(d, float(conv_v))
    if preserve_screen_border:
        divergence_feat = _border_ramp(divergence_feat, divergence, image_width)
        convergence_feat = _border_ramp(convergence_feat, divergence, image_width)
    feats = [d[..., None], divergence_feat[..., None], convergence_feat[..., None]]
    if c is not None:
        gy = torch.linspace(-1, 1, H, dtype=d.dtype, device=d.device)
        gx = torch.linspace(-1, 1, W, dtype=d.dtype, device=d.device)
        grid_x = gx.reshape(1, 1, W, 1).expand(B, H, W, 1)
        grid_y = gy.reshape(1, H, 1, 1).expand(B, H, W, 1)
        return torch.cat([c] + feats + [grid_x, grid_y], dim=-1)
    return torch.cat(feats, dim=-1)


def backward_warp_delta(c, delta, delta_scale, max_shift=None):
    """Warp c (B, H, W, C) by the normalised x-delta (B, h, w), resized
    bilinearly to (H, W) when it differs.  With a ``max_shift`` <= 128 the
    pixel delta is clipped to it and the bounded warp runs; otherwise the
    gather.  Output clipped to [0, 1]."""
    B, H, W, _ = c.shape
    if tuple(delta.shape[1:]) != (H, W):
        delta = resize(delta[..., None], H, W, mode="bilinear",
                       antialias=False)[..., 0]
    delta_px = delta.float() * delta_scale * ((W - 1) / 2.0)
    if max_shift is not None and max_shift <= 128:
        delta_px = delta_px.clamp(-float(max_shift), float(max_shift))
        return _gs.warp_x_bounded(c, delta_px, int(max_shift)).clamp(0.0, 1.0)
    return _gs.warp_x(c, delta_px, padding_mode="border").clamp(0.0, 1.0)


def _delta_max_shift(divergence, base_size: int):
    """Pixel bound of NN stereo deltas: the synthesis shift (divergence %
    of base_size, halved per eye) plus 8 pixels for the learned
    correction."""
    return int(math.ceil(abs(float(divergence)) * 0.01 * base_size * 0.5)) + 8


def apply_divergence_grid_sample(c, depth, divergence, convergence,
                                 synthetic_view: str = "both"):
    """Plain backward warp by the depth itself.  c (B, H, W, 3), depth
    (B, H, W, 1) in [0, 1].  Returns (left, right)."""
    if synthetic_view not in ("both", "right", "left"):
        raise ValueError(synthetic_view)
    B, H, W, _ = depth.shape
    if synthetic_view != "both":
        divergence = divergence * 2
    base_size = max(H, W)
    shift_size = divergence * 0.01
    if torch.is_tensor(convergence) and convergence.dim():
        convergence = convergence.reshape(-1, 1, 1)
    index_shift = depth[..., 0] * shift_size - shift_size * convergence
    delta_px = index_shift * (base_size / W) * ((W - 1) / 2.0)
    max_shift = int(math.ceil(shift_size * (base_size / W) * (W - 1) / 2.0))

    def bwarp(sign):
        if max_shift <= 128:
            out = _gs.warp_x_bounded(c, sign * delta_px, max_shift)
        else:
            out = _gs.warp_x(c, sign * delta_px, padding_mode="border")
        return out.clamp(0.0, 1.0)

    if synthetic_view == "both":
        return bwarp(-1.0), bwarp(1.0)
    if synthetic_view == "right":
        return c, bwarp(1.0)
    return bwarp(-1.0), c


def apply_divergence_nn_delta(model, c, depth, divergence, convergence,
                              steps=1, shift=-1, preserve_screen_border=False):
    """row_flow delta warp.  shift=-1: left eye; shift=+1: right eye (flip,
    warp, flip back).  The model runs on the fp32 packed depth input."""
    steps = 1 if steps is None else steps
    if shift > 0:
        c = c.flip(2)
        depth = depth.flip(2)
    B, H, W, _ = depth.shape
    base_size = max(H, W)
    divergence_step = divergence / steps
    delta_scale = 1.0 / (W // 2 - 1)

    depth_warp = depth
    delta_steps = []
    for j in range(steps):
        x = make_input_tensor(None, depth_warp, divergence=divergence_step,
                              convergence=convergence, image_width=base_size,
                              preserve_screen_border=preserve_screen_border)
        delta_steps.append(model(x)[..., 0])
        if j + 1 < steps:
            depth_warp = backward_warp_delta(
                depth_warp, delta_steps[-1], delta_scale,
                max_shift=_delta_max_shift(divergence_step, W))

    c_warp = c
    ms = _delta_max_shift(divergence_step, c.shape[2])
    for delta in delta_steps:
        c_warp = backward_warp_delta(c_warp, delta, delta_scale, max_shift=ms)
    if shift > 0:
        c_warp = c_warp.flip(2)
    return c_warp


def apply_divergence_nn_delta_weight(model, c, depth, divergence,
                                     convergence, shift=-1,
                                     preserve_screen_border=False,
                                     return_mask=False):
    """MLBW: the sum over the model's layers of c warped by each layer's
    delta, weighted by the layer's softmax weight, clipped to [0, 1].
    shift=-1: left eye; shift=+1: right eye (flip, warp, flip back).
    ``return_mask``: also the hole-mask logits (None without a mask
    head), flipped with the eye."""
    if shift > 0:
        c = c.flip(2)
        depth = depth.flip(2)
    B, H, W, _ = depth.shape
    x = make_input_tensor(None, depth, divergence=divergence,
                          convergence=convergence, image_width=max(H, W),
                          preserve_screen_border=preserve_screen_border)
    out = model(x)
    delta, layer_weight = out[0], out[1]
    hole_mask_logits = out[2] if model.hole_mask else None
    Hc, Wc = c.shape[1:3]
    if tuple(layer_weight.shape[1:3]) != (Hc, Wc):
        layer_weight = resize(layer_weight, Hc, Wc, mode="bilinear",
                              antialias=True)
        # backward_warp_delta's own resize, once for all layers
        delta = resize(delta, Hc, Wc, mode="bilinear", antialias=False)
    delta_scale = 1.0 / (W // 2 - 1)
    ms = _delta_max_shift(divergence, Wc)
    z = torch.zeros_like(c)
    for i in range(model.num_layers):
        z = z + (backward_warp_delta(c, delta[..., i], delta_scale,
                                     max_shift=ms)
                 * layer_weight[..., i:i + 1])
    z = z.clamp(0.0, 1.0)
    if shift > 0:
        z = z.flip(2)
        if hole_mask_logits is not None:
            hole_mask_logits = hole_mask_logits.flip(2)
    if return_mask:
        return z, hole_mask_logits
    return z


def postprocess_hole_mask(mask_logits, target_hw, threshold,
                          inner_dilation=0, outer_dilation=0):
    """Hole mask {0, 1} (B, H, W, 1) from MLBW's logits (B, h, w, 1):
    resize (bilinear, corner-anchored, no antialias), sigmoid > threshold,
    close, grow inward and outward by the dilations (counted at the
    logits' width).

    The JAX function closes the raw logits before the threshold; its
    closing clips to [0, 1], so every sigmoid is >= 0.5 and the mask is
    all ones at any threshold below 0.5 (ROADMAP queue 3).  The port
    closes the thresholded mask, which the closing is made for."""
    base_width = mask_logits.shape[2]
    m = mask_logits.float()
    if tuple(m.shape[1:3]) != tuple(target_hw):
        m = resize(m, target_hw[0], target_hw[1], mode="bilinear",
                   antialias=False, align_corners=True)
    mask = mask_closing((torch.sigmoid(m) > threshold).float(), n_iter=1)
    mask = dilate_inner(mask, n_iter=inner_dilation, base_width=base_width)
    return dilate_outer(mask, n_iter=outer_dilation, base_width=base_width)


def apply_divergence_nn_LR(model, c, depth, divergence, convergence,
                           steps=None, synthetic_view: str = "both",
                           preserve_screen_border: bool = False):
    """row_flow or MLBW (``model.model_name`` "sbs.mlbw") for the
    requested eyes.  Both eyes run as one batch [x, flip(x)]: the right eye
    is the flip-warp-flip of the left, so model and warp run once at 2B.  A
    per-frame (B,) convergence is repeated for the flipped half (the JAX
    package runs the two eyes one after the other there; the results are
    the same)."""
    if synthetic_view not in ("both", "right", "left"):
        raise ValueError(synthetic_view)
    if getattr(model, "model_name", "") == "sbs.mlbw":
        def one(c, depth, div, shift, convergence=convergence):
            return apply_divergence_nn_delta_weight(
                model, c, depth, div, convergence, shift=shift,
                preserve_screen_border=preserve_screen_border)
    else:
        def one(c, depth, div, shift, convergence=convergence):
            return apply_divergence_nn_delta(
                model, c, depth, div, convergence, steps=steps, shift=shift,
                preserve_screen_border=preserve_screen_border)
    if synthetic_view == "both":
        B = c.shape[0]
        if torch.is_tensor(convergence) and convergence.dim():
            convergence = torch.cat([convergence, convergence])
        z = one(torch.cat([c, c.flip(2)], dim=0),
                torch.cat([depth, depth.flip(2)], dim=0), divergence, -1,
                convergence)
        return z[:B], z[B:].flip(2)
    if synthetic_view == "right":
        return c, one(c, depth, divergence * 2, 1)
    return one(c, depth, divergence * 2, -1), c
