"""Layout and window ops on NHWC tensors (counterpart of
``nunif_tpu/modules/permute.py``)."""
import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C) with torch.pixel_shuffle's
    channel-block order: channel c*r*r + dy*r + dx lands at (y*r+dy, x*r+dx).
    """
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of ``pixel_shuffle``: (B, H*r, W*r, C) -> (B, H, W, C*r*r)."""
    b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, c * r * r)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, window, window, C)."""
    b, h, w, c = x.shape
    nh, nw = h // window, w // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window, window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``window_partition``."""
    nh, nw = h // window, w // window
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _pair(r):
    return tuple(r) if isinstance(r, (tuple, list)) else (r, r)


def pixel_shuffle2(x: torch.Tensor, factor) -> torch.Tensor:
    """``pixel_shuffle`` with a (rh, rw) factor: (B, H, W, C*rh*rw) ->
    (B, H*rh, W*rw, C), channel c*rh*rw + dy*rw + dx to (y*rh+dy, x*rw+dx)."""
    rh, rw = _pair(factor)
    b, h, w, crr = x.shape
    c = crr // (rh * rw)
    x = x.reshape(b, h, w, c, rh, rw).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * rh, w * rw, c)


def pixel_unshuffle2(x: torch.Tensor, factor) -> torch.Tensor:
    """Inverse of ``pixel_shuffle2``."""
    rh, rw = _pair(factor)
    b, hr, wr, c = x.shape
    h, w = hr // rh, wr // rw
    x = x.reshape(b, h, rh, w, rw, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, c * rh * rw)


def window_partition2(x: torch.Tensor, window) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, wh*ww, C) with a rectangular window."""
    wh, ww = _pair(window)
    b, h, w, c = x.shape
    nh, nw = h // wh, w // ww
    x = x.reshape(b, nh, wh, nw, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, wh * ww, c)


def window_reverse2(x: torch.Tensor, window, h: int, w: int) -> torch.Tensor:
    """Inverse of ``window_partition2``."""
    wh, ww = _pair(window)
    nh, nw = h // wh, w // ww
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def window_partition3(x: torch.Tensor, window) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nD*nH*nW, wd*wh*ww, C) with a (wd, wh, ww)
    window."""
    wd, wh, ww = window
    b, d, h, w, c = x.shape
    nd, nh, nw = d // wd, h // wh, w // ww
    x = x.reshape(b, nd, wd, nh, wh, nw, ww, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * nd * nh * nw, wd * wh * ww, c)


def window_reverse3(x: torch.Tensor, window, d: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``window_partition3``."""
    wd, wh, ww = window
    nd, nh, nw = d // wd, h // wh, w // ww
    c = x.shape[-1]
    x = x.reshape(-1, nd, nh, nw, wd, wh, ww, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(-1, d, h, w, c)
