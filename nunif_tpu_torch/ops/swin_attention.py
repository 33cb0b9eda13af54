"""K1: one whole Swin-V1 block (norm "none") on an NHWC image.

Replaces ``nunif_tpu/ops/swin_attention.py:fused_swin_block_image`` (Pallas;
kernel ``_kernel_block_img``, body ``_block_compute``).  The Hopper kernel is
``csrc/swin_block.cu``; its header notes what bounds it on the H100 and what
its design does about that.  On swin_unet_2x's 1080p main path it runs 14
times per frame: C = 96 at 1104x1920 and C = 192 at 552x960 and 276x480,
6 heads, 6x6 windows, hidden 2C.

Unlike the TPU function, ``x`` is the unpadded image for shifted blocks too:
the kernel forms the cyclically shifted windows by index arithmetic, so
there is no pad or crop around the call.

``fused_swin_block_image`` takes its plain twin only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from ..modules.permute import window_partition, window_reverse


class PackedBlockWeights(NamedTuple):
    """A block's weights as the kernel reads them, for x of ``dtype``."""
    dtype: torch.dtype
    mats: tuple  # wqkv, wproj, wfc1, wfc2 in dtype (bf16: fragment order)
    biases: tuple  # bqkv, bproj, bfc1, bfc2 in fp32
    rel_bias: torch.Tensor  # (heads, N, N) fp32


def pack_weights(wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias,
                 dtype) -> PackedBlockWeights:
    """Cast and arrange a block's weights for the kernel once; pass the
    result as ``packed=`` so that calls skip this work."""
    mats = [w.to(dtype).contiguous() for w in (wqkv, wproj, wfc1, wfc2)]
    if dtype == torch.bfloat16:
        mats = [_build.mma_weight_layout(w) for w in mats]
    biases = [b.float().contiguous() for b in (bqkv, bproj, bfc1, bfc2)]
    return PackedBlockWeights(dtype, tuple(mats), tuple(biases),
                              rel_bias.float().contiguous())


def swin_block_image_plain(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2,
                           bfc2, rel_bias, *, num_heads, window, shift,
                           skip=None, packed=None):
    """Plain PyTorch twin of ``fused_swin_block_image``: the unfused module
    path (Linear qkv, window partition, attention with relative bias and the
    -100 roll mask, proj + residual, MLP + residual).

    Weights are rounded to x's dtype and every product runs in fp32 on those
    values; results are rounded to x's dtype at the kernel's points (qkv,
    probabilities, attention output, y1, h1, output).  ``packed`` is the
    kernel's form of the same weights and is not used here.
    """
    from ..modules.attention import shifted_window_mask

    dt = x.dtype
    if skip is not None:
        x = x + skip
    B, H, W, C = x.shape
    ws = window
    n = ws * ws
    hd = C // num_heads

    def dense(a, w, b):
        return a.float() @ w.to(dt).float() + b.float()

    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = window_partition(x, ws).reshape(-1, n, C)
    qkv = dense(xw, wqkv, bqkv).to(dt).float()
    q, k, v = qkv.reshape(-1, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + rel_bias.float()[None]
    if shift:
        mask = torch.from_numpy(shifted_window_mask(H, W, ws, shift))
        nw = mask.shape[0]
        attn = attn.reshape(B, nw, num_heads, n, n) + \
            mask.to(x.device)[None, :, None]
        attn = attn.reshape(B * nw, num_heads, n, n)
    probs = torch.softmax(attn, dim=-1).to(dt).float()
    a = (probs @ v).to(dt)
    a = a.transpose(1, 2).reshape(-1, n, C)
    y1 = (dense(a, wproj, bproj) + xw.float()).to(dt)
    h1 = F.gelu(dense(y1, wfc1, bfc1), approximate="none").to(dt)
    out = (dense(h1, wfc2, bfc2) + y1.float()).to(dt)
    out = window_reverse(out.reshape(-1, ws, ws, C), ws, H, W)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out.contiguous()


def _check_on(t, name, x):
    if t.device != x.device:
        raise ValueError(f"fused_swin_block_image: {name} on {t.device}, "
                         f"x on {x.device}")


def fused_swin_block_image(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2,
                           bfc2, rel_bias, *, num_heads, window, shift,
                           skip=None, packed=None):
    """Whole Swin block (norm "none") on x (B, H, W, C), H and W multiples
    of ``window``.

    Weights are Dense-shaped ``(in, out)`` and are cast to x's dtype; biases
    and ``rel_bias`` (heads, N, N) are used in fp32.  ``shift`` > 0 selects
    the cyclically shifted window grid.  ``skip`` (same shape as x, unshifted
    blocks only) is added to x on the first read.  ``packed``, from
    ``pack_weights`` on these weights and x's dtype, saves the per-call cast
    and re-arrangement.
    """
    if skip is not None and shift:
        raise ValueError("skip fusion applies to unshifted blocks only")
    if x.device.type == "cpu":
        return swin_block_image_plain(
            x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias,
            num_heads=num_heads, window=window, shift=shift, skip=skip)
    if x.device.type != "cuda":
        raise ValueError(f"fused_swin_block_image: unsupported device {x.device}")
    code = _build.dtype_code(x.dtype)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"fused_swin_block_image: x must be contiguous NHWC, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    ws = window
    n = ws * ws
    hidden = wfc1.shape[-1]
    if H % ws or W % ws:
        raise ValueError(f"fused_swin_block_image: {H}x{W} not a multiple of "
                         f"window {ws}")
    if C % num_heads or C // num_heads > 64:
        raise ValueError(f"fused_swin_block_image: C={C} with {num_heads} "
                         "heads needs head_dim <= 64")
    if C % 16 or hidden % 16 or (x.dtype == torch.bfloat16
                                 and (C // num_heads) % 16):
        raise ValueError(f"fused_swin_block_image: C={C}, hidden={hidden} and "
                         "(bf16) head_dim must be multiples of 16 (MMA tiles)")
    if n > 48 or not 0 <= shift < ws:
        raise ValueError(f"fused_swin_block_image: window {ws} (at most 6) "
                         f"or shift {shift}")
    expect = {"wqkv": (C, 3 * C), "bqkv": (3 * C,), "wproj": (C, C),
              "bproj": (C,), "wfc1": (C, hidden), "bfc1": (hidden,),
              "wfc2": (hidden, C), "bfc2": (C,),
              "rel_bias": (num_heads, n, n)}
    given = {"wqkv": wqkv, "bqkv": bqkv, "wproj": wproj, "bproj": bproj,
             "wfc1": wfc1, "bfc1": bfc1, "wfc2": wfc2, "bfc2": bfc2,
             "rel_bias": rel_bias}
    for name, t in given.items():
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"fused_swin_block_image: {name} "
                             f"{tuple(t.shape)} != {expect[name]}")
        _check_on(t, name, x)
    if skip is not None:
        if skip.shape != x.shape or skip.dtype != x.dtype \
                or not skip.is_contiguous():
            raise ValueError("fused_swin_block_image: skip must match x in "
                             "shape, dtype and contiguity")
        _check_on(skip, "skip", x)
    if packed is None:
        packed = pack_weights(wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2,
                              bfc2, rel_bias, x.dtype)
    elif packed.dtype != x.dtype:
        raise ValueError(f"fused_swin_block_image: weights packed for "
                         f"{packed.dtype}, x is {x.dtype}")
    ws_, bs_, rb = packed.mats, packed.biases, packed.rel_bias
    for t in (*ws_, *bs_, rb):
        _check_on(t, "packed weights", x)
    if x.data_ptr() % 16 or any(w.data_ptr() % 32 for w in ws_) or (
            skip is not None and skip.data_ptr() % 16):
        raise ValueError("fused_swin_block_image: x and skip must be 16-byte "
                         "and weights 32-byte aligned")
    out = torch.empty_like(x)
    rc = _build.library().nunif_swin_block_image(
        code, x.data_ptr(), None if skip is None else skip.data_ptr(),
        ws_[0].data_ptr(), bs_[0].data_ptr(), ws_[1].data_ptr(),
        bs_[1].data_ptr(), ws_[2].data_ptr(), bs_[2].data_ptr(),
        ws_[3].data_ptr(), bs_[3].data_ptr(), rb.data_ptr(), out.data_ptr(),
        B, H, W, C, num_heads, hidden, ws, shift, float((C // num_heads) ** -0.5),
        _build.stream_ptr(x.device))
    _build.check(rc, "fused_swin_block_image")
    fused_swin_block_image.launches += 1
    return out


fused_swin_block_image.launches = 0
