"""Stereo output composition, NHWC (counterpart of
``nunif_tpu/iw3/composition.py``): IPD offset, padding, SBS, half-SBS, TB,
half-TB, cross-eyed, red-cyan anaglyph, VR180 (equirectangular) and RGBD /
half-RGBD assembly, output size caps.

RGBD and half-RGBD compose the two synthesised eyes side by side, as the
JAX package does (no depth reaches this function; ROADMAP queue 3 holds
the question); they skip the IPD pad, and half-RGBD shares half-SBS's
downscale."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import dtypes
from ..modules.pad import zero_pad2d
from ..modules.resize import resize
from .anaglyph import apply_anaglyph_redcyan
from .equirectangular import equirectangular_projection


@dataclasses.dataclass
class StereoFormat:
    """Output-format switches."""
    half_sbs: bool = False
    tb: bool = False
    half_tb: bool = False
    cross_eyed: bool = False
    anaglyph: Optional[str] = None
    vr180: bool = False
    rgbd: bool = False
    half_rgbd: bool = False
    pad: Optional[float] = None
    pad_mode: str = "tblr"
    ipd_offset: float = 0.0
    max_output_width: Optional[int] = None
    max_output_height: Optional[int] = None
    keep_aspect_ratio: bool = False

    @classmethod
    def from_name(cls, name: str) -> "StereoFormat":
        """sbs (full), half_sbs, tb, half_tb, cross_eyed, anaglyph[:type],
        vr180, rgbd, half_rgbd."""
        name = (name or "sbs").lower()
        if name in ("sbs", "full_sbs"):
            return cls()
        if name == "anaglyph":
            return cls(anaglyph="dubois")
        if name.startswith("anaglyph:"):
            return cls(anaglyph=name.split(":", 1)[1])
        flags = {"half_sbs", "tb", "half_tb", "cross_eyed", "vr180",
                 "rgbd", "half_rgbd"}
        if name not in flags:
            raise ValueError(f"unknown stereo format: {name}")
        return cls(**{name: True})


def postprocess_padding(left_eye, right_eye, pad, pad_mode: str):
    if pad_mode not in ("tblr", "tb", "lr", "16:9", "top"):
        raise ValueError(pad_mode)
    H, W = left_eye.shape[1:3]
    if pad_mode in ("tblr", "tb", "lr"):
        pad_h = round(H * pad) // 2 if "tb" in pad_mode else 0
        pad_w = round(W * pad) // 2 if "lr" in pad_mode else 0
        pads = (pad_w, pad_w, pad_h, pad_h)
        return zero_pad2d(left_eye, pads), zero_pad2d(right_eye, pads)
    if pad_mode == "top":
        pads = (0, 0, round(H * pad), 0)
        return zero_pad2d(left_eye, pads), zero_pad2d(right_eye, pads)
    # 16:9 fit; the pad value is ignored
    target_ratio = 16 / 9
    current_ratio = W / H
    if abs(target_ratio - current_ratio) > 1e-3:
        pad_h = pad_w = 0
        if current_ratio > target_ratio:
            pad_h = (round(W / target_ratio) - H) // 2
        else:
            pad_w = (round(H * target_ratio) - W) // 2
        pads = (pad_w, pad_w, pad_h, pad_h)
        return zero_pad2d(left_eye, pads), zero_pad2d(right_eye, pads)
    return left_eye, right_eye


def postprocess_image(left_eye, right_eye, fmt: StereoFormat):
    """Compose the output frames.  The half-SBS / half-RGBD / half-TB
    downscale runs on both eyes at once in ``dtypes.IMAGE_DTYPE`` (bf16, as
    in the JAX package); VR180 projects each eye; an anaglyph takes
    precedence over TB and cross-eyed."""
    H, W = left_eye.shape[1:3]
    ipd_pad = int(abs(fmt.ipd_offset) * 0.01 * max(H, W))
    ipd_pad -= ipd_pad % 2
    if ipd_pad > 0 and not (fmt.rgbd or fmt.half_rgbd):
        pad_o, pad_i = ((ipd_pad * 2, ipd_pad) if fmt.ipd_offset > 0
                        else (ipd_pad, ipd_pad * 2))
        left_eye = zero_pad2d(left_eye, (pad_o, pad_i, 0, 0))
        right_eye = zero_pad2d(right_eye, (pad_i, pad_o, 0, 0))
    if fmt.pad is not None or fmt.pad_mode == "16:9":
        left_eye, right_eye = postprocess_padding(
            left_eye, right_eye, pad=fmt.pad, pad_mode=fmt.pad_mode)

    if fmt.vr180:
        left_eye = equirectangular_projection(left_eye)
        right_eye = equirectangular_projection(right_eye)
    elif fmt.half_sbs or fmt.half_rgbd or fmt.half_tb:
        h, w = left_eye.shape[1:3]
        B = left_eye.shape[0]
        both = torch.cat([left_eye, right_eye], dim=0).to(dtypes.IMAGE_DTYPE)
        if fmt.half_sbs or fmt.half_rgbd:
            both = resize(both, h, w // 2, mode="bicubic", antialias=True)
        else:
            both = resize(both, h // 2, w, mode="bicubic", antialias=True)
        left_eye = both[:B].to(left_eye.dtype)
        right_eye = both[B:].to(right_eye.dtype)

    if fmt.anaglyph is not None:
        sbs = apply_anaglyph_redcyan(left_eye, right_eye, fmt.anaglyph)
    elif fmt.tb or fmt.half_tb:
        sbs = torch.cat([left_eye, right_eye], dim=1).clamp(0.0, 1.0)
    elif fmt.cross_eyed:
        sbs = torch.cat([right_eye, left_eye], dim=2).clamp(0.0, 1.0)
    else:
        sbs = torch.cat([left_eye, right_eye], dim=2).clamp(0.0, 1.0)

    h, w = sbs.shape[1:3]
    new_w, new_h = w, h
    if fmt.max_output_height is not None and new_h > fmt.max_output_height:
        if fmt.keep_aspect_ratio:
            new_w = int(fmt.max_output_height / new_h * new_w)
        new_h = fmt.max_output_height
    if fmt.max_output_width is not None and new_w > fmt.max_output_width:
        if fmt.keep_aspect_ratio:
            new_h = int(fmt.max_output_width / new_w * new_h)
        new_w = fmt.max_output_width
    if new_w != w or new_h != h:
        new_h -= new_h % 2
        new_w -= new_w % 2
        sbs = resize(sbs, new_h, new_w, mode="bicubic",
                     antialias=True).clamp(0, 1)
    return sbs
