"""2-D DFT as two products with cos / sin bases (counterpart of
``nunif_tpu/modules/spectral.py``: ``dft2``, which the FFT losses use, and
``idft2``, the real part of its inverse, which the FFC discriminator's
``FourierUnit`` uses).

"ortho" normalization (1 / sqrt(HW)), the convention of the reference's
``torch.fft.rfft2(norm="ortho")``.  The JAX package builds the DFT from
products because its TPU backend has no FFT; the port keeps the products
so that both packages sum in the same way.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dft_basis(n: int):
    """(cos, sin) (n, n) float32 of the angle 2 pi j k / n."""
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def dft2(x: torch.Tensor):
    """x (B, H, W, C) real -> (re, im) of its 2-D DFT, fp32, ortho."""
    _b, h, w, _c = x.shape
    x = x.float()
    cw, sw = (torch.from_numpy(a).to(x.device) for a in _dft_basis(w))
    ch, sh = (torch.from_numpy(a).to(x.device) for a in _dft_basis(h))
    re1 = torch.einsum("bhwc,wv->bhvc", x, cw)
    im1 = -torch.einsum("bhwc,wv->bhvc", x, sw)
    re = torch.einsum("bhvc,hu->buvc", re1, ch) + \
        torch.einsum("bhvc,hu->buvc", im1, sh)
    im = torch.einsum("bhvc,hu->buvc", im1, ch) - \
        torch.einsum("bhvc,hu->buvc", re1, sh)
    scale = 1.0 / float(np.sqrt(h * w))
    return re * scale, im * scale


def idft2(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Real part of the inverse of ``dft2``: (re, im) (B, H, W, C) -> (B,
    H, W, C) fp32, ortho."""
    _b, h, w, _c = re.shape
    re, im = re.float(), im.float()
    cw, sw = (torch.from_numpy(a).to(re.device) for a in _dft_basis(w))
    ch, sh = (torch.from_numpy(a).to(re.device) for a in _dft_basis(h))
    # over H with exp(+i a), then over W keeping the real part
    re1 = torch.einsum("buvc,hu->bhvc", re, ch) - \
        torch.einsum("buvc,hu->bhvc", im, sh)
    im1 = torch.einsum("buvc,hu->bhvc", im, ch) + \
        torch.einsum("buvc,hu->bhvc", re, sh)
    out = torch.einsum("bhvc,wv->bhwc", re1, cw) - \
        torch.einsum("bhvc,wv->bhwc", im1, sw)
    return out * (1.0 / float(np.sqrt(h * w)))
