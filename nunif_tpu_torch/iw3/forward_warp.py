"""Depth-ordered bilinear forward warp (splatting) with hole repair, NHWC
(counterpart of ``nunif_tpu/iw3/forward_warp.py``).

Each source pixel splats to the floor and the ceil of its shifted x with
bilinear weights; where several land on one target the nearer (larger
depth) wins, then the larger source x.  The JAX package resolves that with
an int32 key ``depth_q * W + x`` and a max, in one of two forms: an
offset-enumerated select over 2S + 3 candidates for shifts up to 128
pixels, a scatter-max beyond.  Both pick the same winners.  The port takes
the scatter form at every shift: one ``scatter_reduce_(..., "amax")`` a
tap, a single pass whose result does not depend on the order of the
atomics (max is order-free), where the select form would be 2S + 3 eager
passes over the padded frame (S = 20 at 1080p and divergence 2).

The hole repairs are scans: the directional nearest-defined fill is a
prefix max (or suffix min) of positions, ``fix_layered_holes`` a suffix
min (or prefix max) of the warped source index (``torch.cummax`` /
``cummin``).  Plain PyTorch: the JAX module has no Pallas kernel.
"""
from __future__ import annotations

import torch

from ..modules.pad import crop2d, replication_pad2d
from ..modules.pool import box_blur
from ..modules.resize import resize


def _suffix_min(x):
    return x.flip(-1).cummin(dim=-1).values.flip(-1)


def _prefix_max(x):
    return x.cummax(dim=-1).values


def fill_nearest_x(x, sign: int):
    """Directional nearest-defined fill.  x (..., W, C); a pixel is
    undefined where channel 0 < 0.  sign > 0 takes the nearest defined
    pixel at or right of x, sign < 0 at or left of it; pixels with none
    in that direction stay as they are."""
    W = x.shape[-2]
    defined = x[..., 0] >= 0
    pos = torch.arange(W, device=x.device).expand(defined.shape)
    if sign < 0:
        src = _prefix_max(torch.where(defined, pos, -1))
    else:
        src = _suffix_min(torch.where(defined, pos, W))
        src = torch.where(src == W, -1, src)
    gathered = torch.gather(
        x, -2, src.clamp_min(0)[..., None].expand(x.shape))
    return torch.where((src >= 0)[..., None], gathered, x)


def shift_fill(x, sign: int, flip_sign: bool = False, max_tries: int = 100):
    """x (B, H, W, C).  Without ``flip_sign``: ``fill_nearest_x``.  With
    it (``inconsistent_shift``), at most ``max_tries`` passes that each
    take every negative value from its zero-padded neighbour, right for a
    positive sign, and flip the sign, until no negative remains in
    channel 0."""
    if not flip_sign:
        return fill_nearest_x(x, sign)
    for _ in range(max_tries):
        if not bool((x[..., 0] < 0).any()):
            break
        zero = torch.zeros_like(x[:, :, :1])
        if sign > 0:
            taken = torch.cat([x[:, :, 1:], zero], dim=2)
        else:
            taken = torch.cat([zero, x[:, :, :-1]], dim=2)
        x = torch.where(x < 0, taken, x)
        sign = -sign
    return x


def shift_fill_pack(left_eye, right_eye, inconsistent_shift: bool = False):
    """Fill both eyes: the left from the left, the right from the right;
    with ``inconsistent_shift`` both as one channel-stacked tensor through
    ``shift_fill(flip_sign=True)``."""
    if inconsistent_shift:
        n = left_eye.shape[-1]
        pack = shift_fill(torch.cat([left_eye, right_eye], dim=-1), 1,
                          flip_sign=True)
        return pack[..., :n], pack[..., n:]
    left_eye = fill_nearest_x(left_eye, -1)
    right_eye = fill_nearest_x(right_eye.flip(2), -1).flip(2)
    return left_eye, right_eye


def fix_layered_holes(side_image, index_image, sign: int):
    """Mark layered holes (-2) where the warped source index falls back.
    sign > 0 (left eye): the index must not exceed the suffix min of the
    indexes to its right; sign < 0 (right eye): it must not fall below the
    prefix max of those to its left.  A 1e-3 margin keeps bilinear blend
    noise from counting as a jump.  side_image (B, H, W, C), index_image
    (B, H, W, 1) -> (side_image, repaired index)."""
    eps = 1e-3
    idx = index_image[..., 0]
    if sign > 0:
        shifted = torch.cat([_suffix_min(idx)[:, :, 1:], idx[:, :, -1:]], dim=2)
        final_idx = torch.minimum(idx, shifted)
        hole = idx > shifted + eps
    else:
        shifted = torch.cat([idx[:, :, :1], _prefix_max(idx)[:, :, :-1]], dim=2)
        final_idx = torch.maximum(idx, shifted)
        hole = idx < shifted - eps
    side_image = torch.where(hole[..., None], -2.0, side_image)
    return side_image, final_idx[..., None]


def gen_mask2(x):
    """(B, H, W, 1): 1 where undefined (-1), 0.5 at layered holes (-2)."""
    m = x[..., 0:1]
    return ((m == -1).float() + (m == -2).float() * 0.5).clamp(0.0, 1.0)


def blur_blend(x, mask):
    mask = box_blur(mask.to(x.dtype)).clamp(0, 1)
    return x * (1.0 - mask) + box_blur(x) * mask


def _splat(c_packed, depth, index_shift):
    """Forward-warp c_packed (B, H, W, C) fp32 by index_shift (B, H, W)
    pixels with the depth order of ``depth`` (B, H, W) in [0, 1]: each
    target takes, for its floor and its ceil tap, the winner's values and
    weight; -1 where no source landed."""
    B, H, W, C = c_packed.shape
    x_pos = torch.arange(W, dtype=torch.float32, device=c_packed.device)
    fx = (x_pos + index_shift).clamp(0, W - 1)
    floor_fx = torch.floor(fx)
    ceil_fx = torch.ceil(fx)
    ceil_w = (fx - floor_fx).clamp(1e-5, 1.0 - 1e-5)
    floor_w = 1.0 - ceil_w
    # int32 priority: depth quantised (in fp32, half to even, as JAX
    # rounds) above the source x, so max(key) is "nearest, then rightmost"
    q_levels = (2 ** 31 - 2) // W
    depth_q = torch.round(depth * (q_levels - 1)).clamp(0, q_levels - 1)
    key = (depth_q.to(torch.int32) * W
           + torch.arange(W, dtype=torch.int32, device=c_packed.device))
    key = key.reshape(B * H, W)
    vals = c_packed.reshape(B * H, W, C)

    def tap(weight, target):
        best = torch.full_like(key, -1)
        best.scatter_reduce_(1, target.reshape(B * H, W).long(), key,
                             reduce="amax", include_self=True)
        has = (best >= 0)[..., None]
        win_x = torch.where(best >= 0, best % W, 0).long()
        v = torch.gather(vals, 1, win_x[..., None].expand(B * H, W, C))
        w = torch.gather(weight.reshape(B * H, W), 1, win_x)[..., None]
        return (torch.where(has, w, 0.0).reshape(B, H, W, 1),
                torch.where(has, v, -1.0).reshape(B, H, W, C))

    floor_weight, floor_val = tap(floor_w, floor_fx)
    ceil_weight, ceil_val = tap(ceil_w, ceil_fx)
    wsum = floor_weight + ceil_weight
    out = ((floor_val * floor_weight + ceil_val * ceil_weight)
           / wsum.clamp_min(1e-12))
    return torch.where(wsum > 0, out, -1.0)


def depth_order_bilinear_forward_warp(c, depth, divergence, convergence,
                                      fill: bool = True,
                                      synthetic_view: str = "both",
                                      return_mask: bool = False,
                                      inconsistent_shift: bool = False,
                                      width_base: bool = True):
    """c (B, H, W, 3), depth (B, h, w, 1) in [0, 1] -> (left, right) or,
    with ``return_mask``, (left, right, left_mask, right_mask) (``gen_mask2``;
    None for an eye that is the source).  ``fill``: fill holes from the
    nearest defined pixel; else they stay 0 after the clip."""
    if synthetic_view not in ("both", "right", "left"):
        raise ValueError(synthetic_view)
    src_image = c
    if tuple(depth.shape[1:3]) != tuple(c.shape[1:3]):
        depth = resize(depth, c.shape[1], c.shape[2], mode="bilinear",
                       antialias=True)
    if synthetic_view != "both":
        divergence = divergence * 2
    base_size = c.shape[2] if width_base else max(c.shape[1], c.shape[2])
    padding_size = int(base_size * divergence * 0.01 + 2)
    c = replication_pad2d(c, (padding_size, padding_size, 0, 0))
    depth = replication_pad2d(depth, (padding_size, padding_size, 0, 0))

    B, H, W, _ = depth.shape
    d = depth[..., 0].float()
    shift_size = divergence * 0.01 * base_size * 0.5
    # the convergence term in fp32, as JAX computes it
    conv = torch.as_tensor(convergence, dtype=torch.float32, device=d.device)
    if conv.dim():
        conv = conv.reshape(B, 1, 1)
    index_shift = d * shift_size - shift_size * conv
    x_index = torch.arange(W, dtype=torch.float32, device=c.device)
    c_packed = torch.cat([c.float(), x_index.expand(B, H, W)[..., None]],
                         dim=-1)

    def unpack(eye):
        eye = crop2d(eye, (padding_size, padding_size, 0, 0))
        return eye[..., :-1], eye[..., -1:]

    if synthetic_view == "both":
        left, left_idx = unpack(_splat(c_packed, d, index_shift))
        right, right_idx = unpack(_splat(c_packed, d, -index_shift))
        left_idx, right_idx = shift_fill_pack(left_idx, right_idx,
                                              inconsistent_shift)
        left, left_idx = fix_layered_holes(left, left_idx, 1)
        right, right_idx = fix_layered_holes(right, right_idx, -1)
        masks = (gen_mask2(left), gen_mask2(right)) if return_mask else None
        if fill:
            left, right = shift_fill_pack(left, right, inconsistent_shift)
        left, right = left.clamp(0.0, 1.0), right.clamp(0.0, 1.0)
        return (left, right) + masks if return_mask else (left, right)

    if synthetic_view == "right":
        right, right_idx = unpack(_splat(c_packed, d, -index_shift))
        right_idx = fill_nearest_x(right_idx, 1)
        right, right_idx = fix_layered_holes(right, right_idx, -1)
        mask = gen_mask2(right) if return_mask else None
        if fill:
            right = fill_nearest_x(right, 1)
        right = right.clamp(0.0, 1.0)
        return (src_image, right, None, mask) if return_mask else (src_image, right)

    left, left_idx = unpack(_splat(c_packed, d, index_shift))
    left_idx = fill_nearest_x(left_idx, -1)
    left, left_idx = fix_layered_holes(left, left_idx, 1)
    mask = gen_mask2(left) if return_mask else None
    if fill:
        left = fill_nearest_x(left, -1)
    left = left.clamp(0.0, 1.0)
    return (left, src_image, mask, None) if return_mask else (left, src_image)


def apply_divergence_forward_warp(c, depth, divergence, convergence,
                                  method=None, synthetic_view: str = "both",
                                  return_mask: bool = False,
                                  inconsistent_shift: bool = False,
                                  width_base: bool = True):
    """``method`` "forward_fill" fills the holes, "forward" (or None)
    leaves them black."""
    return depth_order_bilinear_forward_warp(
        c, depth, divergence, convergence, fill=method == "forward_fill",
        synthetic_view=synthetic_view, return_mask=return_mask,
        inconsistent_shift=inconsistent_shift, width_base=width_base)
