"""Red-cyan anaglyph composition, NHWC (counterpart of
``nunif_tpu/iw3/anaglyph.py``): the color, gray, half-color, wimmer,
wimmer2, dubois and dubois2 variants.  Dubois works in linear light: the
eyes go through ``_srgb_to_linear``, the two 3x3 matrices (each product
clipped to [0, 1] first for ``dubois``, not for ``dubois2``) and back
through ``_linear_to_srgb``."""
from __future__ import annotations

import torch

_DUBOIS_L = ((0.437, 0.449, 0.164),
             (-0.062, -0.062, -0.024),
             (-0.048, -0.050, -0.017))
_DUBOIS_R = ((-0.011, -0.032, -0.007),
             (0.377, 0.761, 0.009),
             (-0.026, -0.093, 1.234))

ANAGLYPH_TYPES = ["color", "gray", "half-color", "wimmer", "wimmer2",
                  "dubois", "dubois2"]


def grayscale_bt601(x, num_output_channels: int = 1):
    y = x[..., 0:1] * 0.299 + x[..., 1:2] * 0.587 + x[..., 2:3] * 0.114
    return torch.cat([y] * num_output_channels, dim=-1)


def _color(left_eye, right_eye):
    return torch.cat([left_eye[..., 0:1], right_eye[..., 1:3]], dim=-1)


def _half_color(left_eye, right_eye):
    return torch.cat([grayscale_bt601(left_eye), right_eye[..., 1:3]],
                     dim=-1).clamp(0, 1)


def _gray(left_eye, right_eye):
    return torch.cat([grayscale_bt601(left_eye),
                      grayscale_bt601(right_eye, 2)], dim=-1).clamp(0, 1)


def _wimmer(left_eye, right_eye):
    r = left_eye[..., 1:2] * 0.7 + left_eye[..., 2:3] * 0.3
    return torch.cat([r, right_eye[..., 1:3]], dim=-1).clamp(0, 1)


def _wimmer2(left_eye, right_eye):
    def gb(e):
        r, g, b = e[..., 0:1], e[..., 1:2], e[..., 2:3]
        return (g + 0.45 * (r - g).clamp(min=0),
                b + 0.25 * (r - b).clamp(min=0))
    g_l, b_l = gb(left_eye)
    g_r, b_r = gb(right_eye)
    left = (0.75 * g_l + 0.25 * b_l) ** (1.0 / 1.6)
    return torch.cat([left, g_r, b_r], dim=-1).clamp(0, 1)


def _srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(x):
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def _dubois(left_eye, right_eye, clip_before: bool = True):
    le = _srgb_to_linear(left_eye.float())
    re = _srgb_to_linear(right_eye.float())

    def dot_clip(x, row):
        v = (x * torch.tensor(row, dtype=x.dtype, device=x.device)).sum(
            dim=-1, keepdim=True)
        return v.clamp(0, 1) if clip_before else v

    out = torch.cat([dot_clip(le, lrow) + dot_clip(re, rrow)
                     for lrow, rrow in zip(_DUBOIS_L, _DUBOIS_R)], dim=-1)
    return _linear_to_srgb(out.clamp(0, 1)).clamp(0, 1)


def apply_anaglyph_redcyan(left_eye, right_eye, anaglyph_type: str):
    if anaglyph_type == "color":
        return _color(left_eye, right_eye)
    if anaglyph_type == "gray":
        return _gray(left_eye, right_eye)
    if anaglyph_type == "half-color":
        return _half_color(left_eye, right_eye)
    if anaglyph_type == "wimmer":
        return _wimmer(left_eye, right_eye)
    if anaglyph_type == "wimmer2":
        return _wimmer2(left_eye, right_eye)
    if anaglyph_type in ("dubois", "dubois2"):
        return _dubois(left_eye, right_eye, clip_before=anaglyph_type == "dubois")
    raise ValueError(f"Unknown anaglyph_type {anaglyph_type}")
