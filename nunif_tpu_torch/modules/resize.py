"""Image resize as two fp32 matrix products (counterpart of
``nunif_tpu/modules/resize.py``).

The 1-D resampling weights are (out, in) matrices built with numpy, the
same matrices as the JAX package's, so both packages resample identically;
``F.interpolate`` is not a stand-in (its bicubic uses a = -0.75 and no
antialias by default).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x <= 1.0, ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _linear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _lanczos(x: np.ndarray, taps: int = 3) -> np.ndarray:
    y = np.sinc(x) * np.sinc(x / taps)
    return np.where(np.abs(x) < taps, y, 0.0)


_KERNELS = {
    "bicubic": (_cubic, 2.0),
    "bilinear": (_linear, 1.0),
    "box": (_box, 0.5),
    "lanczos": (_lanczos, 3.0),
    "catrom": (functools.partial(_cubic, a=-0.5), 2.0),
}


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str = "bicubic",
                  antialias: bool = True,
                  align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic resampling matrix.
    align_corners=False is the pixel-centre convention; True is torch's
    corner-anchored ``align_corners=True`` (no antialias)."""
    kernel, support = _KERNELS[mode]
    if mode == "bicubic" and antialias:
        # torch's antialias path is PIL-compatible: cubic a = -0.5
        kernel = functools.partial(_cubic, a=-0.5)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        filter_scale = 1.0
        out_coords = np.arange(out_size) * scale
    else:
        scale = in_size / out_size
        # antialias only widens the kernel when downscaling
        filter_scale = max(scale, 1.0) if antialias else 1.0
        out_coords = (np.arange(out_size) + 0.5) * scale - 0.5
    half = support * filter_scale
    lo = np.floor(out_coords - half).astype(np.int64)
    n_taps = int(np.ceil(2 * half)) + 2
    taps = lo[:, None] + np.arange(n_taps)[None, :]
    dist = (out_coords[:, None] - taps) / filter_scale
    w = kernel(dist)
    oob = (taps < 0) | (taps >= in_size)
    if antialias and filter_scale > 1.0:
        # torch/PIL antialias drops out-of-range taps and renormalises
        w = np.where(oob, 0.0, w)
    # otherwise out-of-range taps fold onto the border pixel
    w_sum = w.sum(axis=1, keepdims=True)
    w = w / np.where(w_sum == 0, 1.0, w_sum)
    m = np.zeros((out_size, in_size), np.float64)
    clamped = np.clip(taps, 0, in_size - 1)
    np.add.at(m, (np.repeat(np.arange(out_size), n_taps), clamped.reshape(-1)),
              w.reshape(-1))
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size, out_size, mode, antialias, align_corners, device):
    """The matrix on ``device``, built on the host once; None when it is
    exactly the identity (an axis that keeps its size), whose product would
    change no value."""
    m = resize_matrix(in_size, out_size, mode, antialias, align_corners)
    if in_size == out_size and np.array_equal(m, np.eye(in_size, dtype=m.dtype)):
        return None
    return torch.from_numpy(m).to(device)


def resize(x: torch.Tensor, out_h: int, out_w: int, mode: str = "bicubic",
           antialias: bool = True, align_corners: bool = False) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., out_h, out_w, C): fp32 products of x
    (cast to fp32; float64 stays float64) with the two matrices, cast back
    to x's dtype."""
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    shape = x.shape
    mh = _device_matrix(in_h, out_h, mode, antialias, align_corners, x.device)
    mw = _device_matrix(in_w, out_w, mode, antialias, align_corners, x.device)
    y = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
        (-1,) + tuple(shape[-3:]))
    if mh is not None:
        y = torch.einsum("oh,bhwc->bowc", mh.to(y.dtype), y)
    if mw is not None:
        y = torch.einsum("pw,bowc->bopc", mw.to(y.dtype), y)
    return y.reshape(tuple(shape[:-3]) + (out_h, out_w, shape[-1])).to(x.dtype)
