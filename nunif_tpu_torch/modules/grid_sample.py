"""Grid sampling and the horizontal stereo warps on NHWC tensors
(counterpart of ``nunif_tpu/modules/grid_sample.py``: ``grid_sample``,
``warp_x`` and ``warp_x_bounded``).

``grid_sample`` is torch's ``F.grid_sample`` on an NCHW view: the JAX
function follows torch's convention (bicubic a = -0.75, out-of-range taps
by padding mode), and no Pallas kernel computes it.  Reflection with
``align_corners=False`` raises: there the JAX function reflects around
[0, size - 1] and torch around [-0.5, size - 0.5].

K3: ``warp_x_bounded`` replaces ``_warp_x_bounded_pallas``.  The Hopper
kernel is ``csrc/warp_x.cu``; its header notes what bounds it on the H100
and what its design does about that.  On iw3's main path it runs the
row_flow_v3 warp of both eyes at once: (16, 1080, 1920, 3), max_shift 28,
one launch a batch of 8 frames.

The kernel reads x in its own dtype (fp32 on the path, or bf16), rounds
its taps to bf16 in registers and writes x's dtype, so no cast pass runs
around the launch.  ``warp_x_bounded`` takes its plain twin only for CPU
tensors; for a CUDA tensor it launches the kernel or raises, and it
raises while autograd records an input that needs a gradient (the launch
has no backward).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core import dtypes
from ..ops import _build


def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "border",
                align_corners: bool = True):
    """Sample x (B, H, W, C) at grid (B, Ho, Wo, 2), [-1, 1] coordinates,
    grid[..., 0] the width axis: (B, Ho, Wo, C), fp32 arithmetic, x's
    dtype.  mode nearest / bilinear / bicubic; padding zeros / border /
    reflection."""
    if padding_mode == "reflection" and not align_corners:
        raise NotImplementedError(
            "grid_sample: reflection with align_corners=False")
    y = F.grid_sample(x.float().permute(0, 3, 1, 2), grid.float(), mode=mode,
                      padding_mode=padding_mode, align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def warp_x(x, delta_px, padding_mode: str = "border"):
    """Horizontal-only bilinear backward warp by a gather, for any delta.

    x (B, H, W, C); delta_px (B, H, W) pixels added to each output pixel's
    source x coordinate.  fp32 arithmetic, output in x's dtype.
    """
    if padding_mode not in ("border", "zeros"):
        raise ValueError(padding_mode)
    B, H, W, C = x.shape
    base = torch.arange(W, dtype=torch.float32, device=x.device)
    gx = base + delta_px.float()
    x0 = torch.floor(gx)
    t = gx - x0
    xf = x.float()

    def gather(ix):
        valid = (ix >= 0) & (ix <= W - 1)
        ix = ix.clamp(0, W - 1).long()
        v = torch.gather(xf, 2, ix[..., None].expand(B, H, W, C))
        return v, valid

    v0, m0 = gather(x0)
    v1, m1 = gather(x0 + 1)
    w0, w1 = (1.0 - t)[..., None], t[..., None]
    if padding_mode == "zeros":
        w0 = w0 * m0[..., None]
        w1 = w1 * m1[..., None]
    return (v0 * w0 + v1 * w1).to(x.dtype)


def warp_x_bounded_plain(x, delta_px, max_shift: int):
    """Plain twin of ``warp_x_bounded``: the offset sum of
    ``grid_sample.py:242-269``.  x is read in ``dtypes.IMAGE_DTYPE``; hat
    weights and the sum are fp32; the result is cast to x's dtype.  Wherever
    |delta| <= max_shift it equals ``warp_x`` (border) on the rounded x."""
    B, H, W, C = x.shape
    S = int(max_shift) + 1
    base = torch.arange(W, dtype=torch.float32, device=x.device)
    gx = (base + delta_px.float()).clamp(0, W - 1)
    xc = x.to(dtypes.IMAGE_DTYPE)
    xp = torch.cat([xc[:, :, :1].expand(B, H, S, C), xc,
                    xc[:, :, -1:].expand(B, H, S, C)], dim=2)
    out = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for o in range(-S, S + 1):
        w = torch.clamp(1.0 - torch.abs(gx - (base + o)), min=0.0)
        out = out + xp[:, :, o + S:o + S + W, :].float() * w[..., None]
    return out.to(x.dtype)


_PLAN_KEYS = ("seg", "nseg", "halo", "cap", "smem")


def warp_x_plan(w: int, c: int, dtype, max_shift: int) -> dict:
    """K3's launch plan for rows of ``w`` pixels of ``c`` channels of
    ``dtype`` (fp32 or bf16) and ``max_shift`` (card only: asks the built
    library, ``csrc/warp_x.cu:warp_plan``): columns a unit writes
    (``seg``), units a row (``nseg``), ``halo`` columns staged on each side
    of a segment, columns a ring stage holds (``cap``) and shared-memory
    bytes a block (``smem``).  Raises RuntimeError for a shape the kernel
    does not take."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    _build.check(_build.library().nunif_warp_x_plan(
        w, c, _build.dtype_code(dtype), max_shift, out), "warp_x_plan")
    return dict(zip(_PLAN_KEYS, out))


def warp_x_bounded_kernel(x, delta_px, max_shift: int):
    """Launch K3 on x (B, H, W, C <= 8), fp32 or bf16, and fp32 delta (B,
    H, W), both contiguous on one CUDA device; returns (B, H, W, C) in x's
    dtype.  Each launch adds one to ``warp_x_bounded.launches``."""
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    rc = _build.library().nunif_warp_x_bounded(
        _build.dtype_code(x.dtype), x.data_ptr(), delta_px.data_ptr(),
        out.data_ptr(), B, H, W, C, int(max_shift), _build.stream_ptr(x.device))
    _build.check(rc, "warp_x_bounded")
    warp_x_bounded.launches += 1
    return out


def warp_x_bounded(x, delta_px, max_shift: int):
    """Horizontal bilinear backward warp with border padding, for
    |delta_px| <= max_shift (beyond it the offset sum drops taps and the
    kernel's gather does not, so the two are not meant to agree there).

    x (B, H, W, C <= 8); delta_px (B, H, W).  x is read in
    ``dtypes.IMAGE_DTYPE``, which must be bf16 on CUDA (the kernel rounds
    its taps to bf16).  Returns x's dtype.
    """
    if torch.compiler.is_compiling():
        raise NotImplementedError(
            "warp_x_bounded: kernel K3 is not a torch.library op, so "
            "torch.export cannot record it (models/export.py); no exported "
            "model reaches it")
    if x.device.type == "cpu":
        return warp_x_bounded_plain(x, delta_px, max_shift)
    if x.device.type != "cuda":
        raise ValueError(f"warp_x_bounded: unsupported device {x.device}")
    _build.refuse_grad("warp_x_bounded", x, delta_px)
    return _warp_x_bounded_cuda(x, delta_px, max_shift)


def _warp_x_bounded_cuda(x, delta_px, max_shift: int):
    """The checks and the launch of ``warp_x_bounded`` for a CUDA x: fp32
    and bf16 x go to the kernel as they are (it reads and writes x's
    dtype); another float dtype through an fp32 copy."""
    if dtypes.IMAGE_DTYPE != torch.bfloat16:
        raise TypeError(f"warp_x_bounded: the kernel reads bfloat16, not "
                        f"{dtypes.IMAGE_DTYPE}")
    if x.dim() != 4 or not 1 <= x.shape[3] <= 8:
        raise ValueError(f"warp_x_bounded: x must be (B, H, W, C <= 8), got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    if tuple(delta_px.shape) != (B, H, W):
        raise ValueError(f"warp_x_bounded: delta {tuple(delta_px.shape)} != "
                         f"{(B, H, W)}")
    if delta_px.device != x.device:
        raise ValueError(f"warp_x_bounded: delta on {delta_px.device}, x on "
                         f"{x.device}")
    delta_px = delta_px.to(torch.float32).contiguous()
    if x.dtype in (torch.float32, torch.bfloat16):
        return warp_x_bounded_kernel(x.contiguous(), delta_px, max_shift)
    return warp_x_bounded_kernel(x.float().contiguous(), delta_px,
                                 max_shift).to(x.dtype)


warp_x_bounded.launches = 0
