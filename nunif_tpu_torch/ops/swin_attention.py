"""Swin window attention kernels K1, K4, K5 and K6.

K1: one whole Swin-V1 block (norm "none") on an NHWC image.  Replaces
``nunif_tpu/ops/swin_attention.py:fused_swin_block_image`` (Pallas; kernel
``_kernel_block_img``, body ``_block_compute``).  The Hopper kernel is
``csrc/swin_block.cu``.  On swin_unet_2x's 1080p main path it runs 14
times per frame: C = 96 at 1104x1920 and C = 192 at 552x960 and 276x480,
6 heads, 6x6 windows, hidden 2C.  Unlike the TPU function, ``x`` is the
unpadded image for shifted blocks too: the kernel forms the cyclically
shifted windows by index arithmetic, so there is no pad or crop around the
call.  In bf16 it is a persistent kernel whose four dense GEMMs run on
wgmma, with the weights streamed into shared memory by bulk copies in the
layout ``pack_weights`` makes once per weight load.

K4: window attention on already projected qkv, for the blocks with a
LayerNorm.  Replaces ``nunif_tpu/ops/swin_attention.py:fused_window_attention``
(Pallas; kernel ``_kernel``).  The Hopper kernel is ``csrc/window_attn.cu``.
On swin_unet_4xl's 540p main path it runs 14 times per frame: C = 192 at
576x960, C = 384 at 288x480, 144x240 and 576x960, 12 heads, 6x6 windows.
It takes windows of up to 64 tokens, as the TPU kernel does: imagenet
swin_t's window 7 (N = 49, head dim 32) and window 8.  K1 and K5 keep
window 6, their only callers'.

K5: K1's block on window-ordered tokens (nw, N, C).  Replaces
``nunif_tpu/ops/swin_attention.py:fused_swin_block`` (Pallas; kernel
``_kernel_block``); the Hopper kernel is K1's (``csrc/swin_block.cu``) with
a row table in place of the pixel table.  The block module runs it when
``NUNIF_TPU_SWIN_IMG`` is not "1": shifted blocks pad the image by
shift / window - shift and mask keys outside it (``shift_mode="pad"``).

K6: K4's attention on qkv in image layout (B, H, W, 3C), already rolled.
Replaces ``nunif_tpu/ops/swin_attention.py:fused_window_attention_image``
(Pallas; kernel ``_kernel_img``); the Hopper kernel is K4's
(``csrc/window_attn.cu``) with image-layout addressing.

Each kernel's header notes what bounds it on the H100 and what its design
does about that.  The wrappers take their plain twins only for CPU
tensors; for a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from ..modules.permute import (window_partition, window_partition2,
                               window_reverse, window_reverse2)


class PackedBlockWeights(NamedTuple):
    """A block's weights as the kernel reads them, for x of ``dtype``."""
    dtype: torch.dtype
    # wqkv, wproj, wfc1, wfc2 in dtype: fp32 the (in, out) matrices; bf16
    # wgmma's B layout in column chunks of chunk_width(C, hidden)
    mats: tuple
    biases: tuple  # bqkv, bproj, bfc1, bfc2 in fp32
    rel_bias: torch.Tensor  # (heads, N, N) fp32


def chunk_width(c: int, hidden: int) -> int:
    """Output columns of one weight chunk of the bf16 kernel (its wgmma
    N): 96 where C and hidden are multiples of 96 (swin_unet's 96 and
    192), else 16.  The pack decides; the wrappers pass the kernel the
    width of the pack they hand it (``_chunk_of``)."""
    return 96 if c % 96 == 0 and hidden % 96 == 0 else 16


def _chunk_of(packed) -> int:
    """The chunk width a packed bf16 wqkv was laid out with (0 for fp32)."""
    if packed.dtype != torch.bfloat16:
        return 0
    return packed.mats[0].shape[2] * 8


def block_plan(c: int, hidden: int, window: int) -> dict:
    """The bf16 kernel's plan for a block of width ``c``, MLP width
    ``hidden`` and ``window`` with weights packed by ``pack_weights`` (card
    only: asks the built library): token rows a tile, whole windows a tile,
    k16 steps a weight piece, ring stages and shared-memory bytes."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().nunif_swin_block_plan(
        c, hidden, window, chunk_width(c, hidden), out), "block_plan")
    return dict(zip(("rows", "windows", "kper", "stages", "smem"), out))


def _packed_shapes(c, hidden, dtype):
    mats = ((c, 3 * c), (c, c), (c, hidden), (hidden, c))
    if dtype != torch.bfloat16:
        return mats
    nb = chunk_width(c, hidden)
    return tuple((n // nb, k // 16, nb // 8, 2, 8, 8) for k, n in mats)


def pack_weights(wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias,
                 dtype) -> PackedBlockWeights:
    """Cast and arrange a block's weights for the kernel once; pass the
    result as ``packed=`` so that calls skip this work.  bf16: each (in,
    out) matrix W rounded to bf16 in ``_build.wgmma_weight_layout`` with
    nb = ``chunk_width(C, hidden)``, shape (out / nb, in / 16, nb / 8, 2, 8,
    8), element [h, ks, n8, kb, r, c] = W[16 ks + 8 kb + c, nb h + 8 n8 +
    r]: the kernel's bulk copies take k16 steps of one column chunk, which
    lie contiguous."""
    mats = [w.to(dtype).contiguous() for w in (wqkv, wproj, wfc1, wfc2)]
    if dtype == torch.bfloat16:
        nb = chunk_width(wqkv.shape[0], wfc1.shape[-1])
        mats = [_build.wgmma_weight_layout(w, nb) for w in mats]
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

    if skip is not None:
        x = x + skip
    B, H, W, C = x.shape
    ws = window
    n = ws * ws
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = window_partition(x, ws).reshape(-1, n, C)
    mask = torch.from_numpy(shifted_window_mask(H, W, ws, shift)) \
        if shift else None
    out = _block_windows(xw, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                         rel_bias, mask, num_heads)
    out = window_reverse(out.reshape(-1, ws, ws, C), ws, H, W)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out.contiguous()


def _block_windows(xw, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                   rel_bias, mask, num_heads):
    """The block on window tokens xw (nw, N, C), as the twins of K1 and K5
    compute it; ``mask`` (windows of one image, N or 1, N) of 0 / -100 is
    added to the logits of each image's windows."""
    dt = xw.dtype
    nw, n, C = xw.shape
    hd = C // num_heads

    def dense(a, w, b):
        return a.float() @ w.to(dt).float() + b.float()

    qkv = dense(xw, wqkv, bqkv).to(dt).float()
    q, k, v = qkv.reshape(-1, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + rel_bias.float()[None]
    if mask is not None:
        per_img = mask.shape[0]
        attn = attn.reshape(-1, per_img, num_heads, n, n) + \
            mask.to(xw.device)[None, :, None]
        attn = attn.reshape(nw, num_heads, n, n)
    probs = torch.softmax(attn, dim=-1).to(dt).float()
    a = (probs @ v).to(dt)
    a = a.transpose(1, 2).reshape(-1, n, C)
    y1 = (dense(a, wproj, bproj) + xw.float()).to(dt)
    h1 = F.gelu(dense(y1, wfc1, bfc1), approximate="none").to(dt)
    return (dense(h1, wfc2, bfc2) + y1.float()).to(dt)


def _check_on(t, name, x, what):
    if t.device != x.device:
        raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")


def _block_weights(what, x, C, weights, packed, *, num_heads, window, shift):
    """The checks K1 and K5 share: token width C, window, shift and the
    weights' shapes, devices and alignment.  Returns the packed weights."""
    wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias = weights
    ws = window
    n = ws * ws
    hidden = wfc1.shape[-1]
    if C % num_heads or C // num_heads > 64:
        raise ValueError(f"{what}: C={C} with {num_heads} heads needs "
                         "head_dim <= 64")
    if C % 16 or hidden % 16 or (x.dtype == torch.bfloat16
                                 and (C // num_heads) % 16):
        raise ValueError(f"{what}: C={C}, hidden={hidden} and (bf16) "
                         "head_dim must be multiples of 16 (MMA tiles)")
    if n > 48 or not 0 <= shift < ws:
        raise ValueError(f"{what}: window {ws} (at most 6) or shift {shift}")
    expect = {"wqkv": (C, 3 * C), "bqkv": (3 * C,), "wproj": (C, C),
              "bproj": (C,), "wfc1": (C, hidden), "bfc1": (hidden,),
              "wfc2": (hidden, C), "bfc2": (C,),
              "rel_bias": (num_heads, n, n)}
    for name, t in zip(expect, weights):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != "
                             f"{expect[name]}")
        _check_on(t, name, x, what)
    if packed is None:
        packed = pack_weights(*weights, x.dtype)
    elif packed.dtype != x.dtype or tuple(
            tuple(m.shape) for m in packed.mats) != _packed_shapes(
                C, hidden, x.dtype):
        raise ValueError(f"{what}: weights packed for {packed.dtype} "
                         f"{[tuple(m.shape) for m in packed.mats]}, x is "
                         f"{x.dtype} with C={C}, hidden={hidden}")
    for t in (*packed.mats, *packed.biases, packed.rel_bias):
        _check_on(t, "packed weights", x, what)
    if any(w.data_ptr() % 32 for w in packed.mats):
        raise ValueError(f"{what}: weights must be 32-byte aligned")
    return packed


def _packed_args(packed):
    """(wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias) pointers."""
    (wq, wp, w1, w2), (bq, bp, b1, b2) = packed.mats, packed.biases
    return [t.data_ptr() for t in (wq, bq, wp, bp, w1, b1, w2, b2,
                                   packed.rel_bias)]


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
    what = "fused_swin_block_image"
    if skip is not None and shift:
        raise ValueError("skip fusion applies to unshifted blocks only")
    if x.device.type == "cpu":
        return swin_block_image_plain(
            x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias,
            num_heads=num_heads, window=window, shift=shift, skip=skip)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    code = _build.dtype_code(x.dtype)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    ws = window
    if H % ws or W % ws:
        raise ValueError(f"{what}: {H}x{W} not a multiple of window {ws}")
    weights = (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel_bias)
    packed = _block_weights(what, x, C, weights, packed, num_heads=num_heads,
                            window=ws, shift=shift)
    if skip is not None:
        if skip.shape != x.shape or skip.dtype != x.dtype \
                or not skip.is_contiguous():
            raise ValueError(f"{what}: skip must match x in shape, dtype and "
                             "contiguity")
        _check_on(skip, "skip", x, what)
    if x.data_ptr() % 16 or (skip is not None and skip.data_ptr() % 16):
        raise ValueError(f"{what}: x and skip must be 16-byte aligned")
    out = torch.empty_like(x)
    rc = _build.library().nunif_swin_block_image(
        code, x.data_ptr(), None if skip is None else skip.data_ptr(),
        *_packed_args(packed), out.data_ptr(), B, H, W, C, num_heads,
        wfc1.shape[-1], ws, shift, _chunk_of(packed),
        float((C // num_heads) ** -0.5), _build.stream_ptr(x.device))
    _build.check(rc, what)
    fused_swin_block_image.launches += 1
    return out


fused_swin_block_image.launches = 0

SHIFT_MODES = ("roll", "pad")


def swin_block_plain(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                     bias, *, num_heads, window, shift, n_wh, n_ww,
                     shift_mode="roll", packed=None):
    """Plain PyTorch twin of ``fused_swin_block``: K1's twin on the window
    tokens as given, with the roll region mask (``shifted_window_mask``) or
    the pad key mask (``padded_window_key_mask``) for shift > 0.  ``packed``
    is the kernel's form of the weights and is not used here."""
    from ..modules.attention import (padded_window_key_mask,
                                     shifted_window_mask)
    mask = None
    if shift and shift_mode == "pad":
        mask = padded_window_key_mask(n_wh, n_ww, window, shift)
    elif shift:
        mask = shifted_window_mask(n_wh * window, n_ww * window, window, shift)
    return _block_windows(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                          bias, None if mask is None else torch.from_numpy(mask),
                          num_heads)


def fused_swin_block(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                     bias, *, num_heads, window, shift, n_wh, n_ww,
                     shift_mode="roll", packed=None):
    """Whole Swin block (norm "none") on window-ordered tokens x (nw, N, C),
    windows in (batch, window row, window column) order of an n_wh x n_ww
    grid.  Returns (nw, N, C) in x's dtype.

    ``shift_mode="roll"``: the windows of the cyclically rolled image, with
    the wrap-region mask.  ``"pad"``: the windows of an image padded by
    ``shift`` top-left and ``window - shift`` bottom-right, keys outside the
    unpadded image masked.  Weights, ``bias`` (heads, N, N) and ``packed``
    as for ``fused_swin_block_image``.
    """
    what = "fused_swin_block"
    kw = dict(num_heads=num_heads, window=window, shift=shift, n_wh=n_wh,
              n_ww=n_ww, shift_mode=shift_mode)
    if shift_mode not in SHIFT_MODES:
        raise ValueError(f"{what}: shift_mode {shift_mode!r} not in "
                         f"{SHIFT_MODES}")
    if x.device.type == "cpu":
        return swin_block_plain(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2,
                                bfc2, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    code = _build.dtype_code(x.dtype)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (nw, N, C), got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    nw, n, C = x.shape
    if n != window * window:
        raise ValueError(f"{what}: N={n} must be window^2 for window {window}")
    if n_wh < 1 or n_ww < 1 or nw % (n_wh * n_ww):
        raise ValueError(f"{what}: {nw} windows for a {n_wh}x{n_ww} window "
                         "grid")
    weights = (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, bias)
    packed = _block_weights(what, x, C, weights, packed, num_heads=num_heads,
                            window=window, shift=shift)
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    out = torch.empty_like(x)
    rc = _build.library().nunif_swin_block_windows(
        code, x.data_ptr(), *_packed_args(packed), out.data_ptr(), nw, C,
        num_heads, wfc1.shape[-1], window, shift, int(shift_mode == "pad"),
        n_wh, n_ww, _chunk_of(packed), float((C // num_heads) ** -0.5),
        _build.stream_ptr(x.device))
    _build.check(rc, what)
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


def window_attention_plain(qkv, bias, *, num_heads, window, shift, n_wh, n_ww):
    """Plain PyTorch twin of ``fused_window_attention``: the attention of
    the unfused module path, fp32 scores of the qkv values, the relative
    bias and the ``shifted_window_mask`` constant, an fp32 softmax whose
    probabilities are rounded to qkv's dtype, fp32 P V rounded to qkv's
    dtype."""
    from ..modules.attention import shifted_window_mask

    dt = qkv.dtype
    nw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    q, k, v = qkv.float().reshape(nw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias.float()[None]
    if shift:
        mask = torch.from_numpy(shifted_window_mask(
            n_wh * window, n_ww * window, window, shift)).to(qkv.device)
        attn = attn.reshape(-1, n_wh * n_ww, num_heads, n, n) + mask[None, :, None]
        attn = attn.reshape(nw, num_heads, n, n)
    probs = torch.softmax(attn, dim=-1).to(dt).float()
    out = (probs @ v).to(dt)
    return out.transpose(1, 2).reshape(nw, n, c)


def fused_window_attention(qkv, bias, *, num_heads, window, shift, n_wh, n_ww):
    """Window attention on projected qkv (nw, N, 3C), N = window^2, windows
    in (batch, window row, window column) order of an image of n_wh x n_ww
    windows, rolled by ``shift`` when ``shift`` > 0 (the -100 wrap mask is
    computed, not stored).  bias: (heads, N, N) relative position bias, used
    in fp32.  Returns (nw, N, C) in qkv's dtype.

    On CUDA: bf16 or fp32, contiguous 16-byte aligned qkv, N <= 64 (window
    8) and a head dim that is a multiple of 16 and at most 64.
    """
    kw = dict(num_heads=num_heads, window=window, shift=shift, n_wh=n_wh,
              n_ww=n_ww)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {qkv.device}")
    code = _build.dtype_code(qkv.dtype)
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"fused_window_attention: qkv must be a contiguous "
                         f"(nw, N, 3C), got {tuple(qkv.shape)} strides "
                         f"{qkv.stride()}")
    nw, n, c3 = qkv.shape
    c = c3 // 3
    if n != window * window or n > 64:
        raise ValueError(f"fused_window_attention: N={n} must be window^2 "
                         f"for window {window} and at most 64")
    if c3 % 3 or c % num_heads or (c // num_heads) % 16 or c // num_heads > 64:
        raise ValueError(f"fused_window_attention: 3C={c3} with {num_heads} "
                         "heads needs a head dim that is a multiple of 16 "
                         "and at most 64")
    if not 0 <= shift < window or nw % (n_wh * n_ww):
        raise ValueError(f"fused_window_attention: shift {shift}, {nw} "
                         f"windows for a {n_wh}x{n_ww} window grid")
    if tuple(bias.shape) != (num_heads, n, n) or bias.device != qkv.device:
        raise ValueError(f"fused_window_attention: bias {tuple(bias.shape)} "
                         f"on {bias.device} != ({num_heads}, {n}, {n}) on "
                         f"{qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("fused_window_attention: qkv must be 16-byte aligned")
    bias = bias.float().contiguous()
    out = torch.empty((nw, n, c), dtype=qkv.dtype, device=qkv.device)
    rc = _build.library().nunif_window_attn(
        code, qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), nw, n, c,
        num_heads, window, shift, n_wh, n_ww, float((c // num_heads) ** -0.5),
        _build.stream_ptr(qkv.device))
    _build.check(rc, "fused_window_attention")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


def window_attention_image_plain(qkv, bias, *, num_heads, window, shift):
    """Plain PyTorch twin of ``fused_window_attention_image``: window
    partition, K4's twin (same roundings), window reverse."""
    B, H, W, _c3 = qkv.shape
    out = window_attention_plain(
        window_partition2(qkv, window), bias, num_heads=num_heads,
        window=window, shift=shift, n_wh=H // window, n_ww=W // window)
    return window_reverse2(out, window, H, W)


def fused_window_attention_image(qkv, bias, *, num_heads, window, shift):
    """Window attention on projected qkv in image layout (B, H, W, 3C),
    after any cyclic roll by ``shift``, H and W multiples of ``window``; the
    -100 wrap mask comes from each window's grid position.  bias: (heads,
    N, N), used in fp32.  Returns (B, H, W, C) in qkv's dtype.

    On CUDA: K4's limits (bf16 or fp32, contiguous 16-byte aligned qkv,
    N <= 64, head dim a multiple of 16 and at most 64).
    """
    what = "fused_window_attention_image"
    kw = dict(num_heads=num_heads, window=window, shift=shift)
    if qkv.device.type == "cpu":
        return window_attention_image_plain(qkv, bias, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv.device}")
    code = _build.dtype_code(qkv.dtype)
    if qkv.dim() != 4 or not qkv.is_contiguous():
        raise ValueError(f"{what}: qkv must be a contiguous (B, H, W, 3C), "
                         f"got {tuple(qkv.shape)} strides {qkv.stride()}")
    B, H, W, c3 = qkv.shape
    c = c3 // 3
    n = window * window
    if H % window or W % window or n > 64:
        raise ValueError(f"{what}: {H}x{W} not a multiple of window {window} "
                         "or window^2 > 64")
    if c3 % 3 or c % num_heads or (c // num_heads) % 16 or c // num_heads > 64:
        raise ValueError(f"{what}: 3C={c3} with {num_heads} heads needs a "
                         "head dim that is a multiple of 16 and at most 64")
    if not 0 <= shift < window:
        raise ValueError(f"{what}: shift {shift} for window {window}")
    if tuple(bias.shape) != (num_heads, n, n) or bias.device != qkv.device:
        raise ValueError(f"{what}: bias {tuple(bias.shape)} on {bias.device} "
                         f"!= ({num_heads}, {n}, {n}) on {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be 16-byte aligned")
    bias = bias.float().contiguous()
    out = torch.empty((B, H, W, c), dtype=qkv.dtype, device=qkv.device)
    rc = _build.library().nunif_window_attn_image(
        code, qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, c,
        num_heads, window, shift, float((c // num_heads) ** -0.5),
        _build.stream_ptr(qkv.device))
    _build.check(rc, what)
    fused_window_attention_image.launches += 1
    return out


fused_window_attention_image.launches = 0
