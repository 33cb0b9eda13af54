"""Hopper probes T1, T3 and T4: the questions of the JAX package's
``tools/microbench_*`` Pallas probes, asked of the H100.

T1 ``strip_pass`` / ``strip_relayout``: replaces
``tools/microbench_strip.py:strip_call`` (kernels ``_pass_kernel``,
``_relayout_kernel``).  x * scale on a bf16 image, streamed, or through a
strip <-> window relayout in shared memory (``csrc/probe_strip.cu``).

T3 ``window_dots``: replaces ``tools/microbench_int8_attn.py:bench``
(``_kernel_bf16``, ``_kernel_int8``).  Per window the dot pair of
head-packed attention with exp2 between, bf16 or int8, streamed from
device memory (``csrc/probe_window_dots.cu``).

T4 ``window_dots_repeat``: replaces ``tools/microbench_mxu_dots.py:bench``
(``_mk_kernel``).  The dot pair repeated on resident operands with a data
dependency (``csrc/probe_window_dots.cu``).

Each has a plain PyTorch twin beside it; the wrappers take the twins only
for CPU tensors and launch their kernel or raise for CUDA tensors.
Integer products in the int8 twins run in float64, where every sum at
these sizes is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ..modules.permute import window_partition2, window_reverse2

STRIP_SCALE = 1.0009765625  # the tool's constant; 1.0 once rounded to bf16
INT8_SCALE = 1.0 / (127.0 * 127.0)
REPS = 64
BLOCK_WINDOWS = 16
_DOT_BF16, _DOT_INT8 = 1, 2


def _scale_of(x):
    """STRIP_SCALE rounded to x's dtype, as the tool's
    ``jnp.asarray(scale, x.dtype)``, on x's device."""
    return torch.tensor(STRIP_SCALE, dtype=x.dtype).to(x.device)


def strip_plain(x):
    """The function both T1 kernels compute: x * STRIP_SCALE in x's dtype."""
    return x * _scale_of(x)


def strip_partition_roundtrip(x, window=6):
    """The relayout through device memory: window partition, scale, window
    reverse (the counterpart of the tool's ``xla_partition_roundtrip``)."""
    _b, h, w, _c = x.shape
    return window_reverse2(window_partition2(x, window) * _scale_of(x),
                           window, h, w)


def _strip(relayout, fn, x, rh, cw, window):
    what = fn.__name__
    if x.device.type == "cpu":
        return strip_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[0] != 1 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be a contiguous 16-byte aligned "
                         f"bf16 (1, H, W, C), got {x.dtype} "
                         f"{tuple(x.shape)}")
    _b, h, w, c = x.shape
    if h % (rh * window) or w % (cw * window) or c % 8:
        raise ValueError(f"{what}: {h}x{w}x{c} is not a grid of "
                         f"{rh}x{cw} windows of {window} with C % 8 == 0")
    out = torch.empty_like(x)
    rc = _build.library().nunif_strip(
        int(relayout), x.data_ptr(), out.data_ptr(), h, w, c, window, rh, cw,
        float(_scale_of(x)), _build.stream_ptr(x.device))
    _build.check(rc, what)
    fn.launches += 1
    return out


def strip_pass(x, rh, cw, *, window=6):
    """T1 pass kernel: x * STRIP_SCALE, one block a (rh x cw)-window
    block."""
    return _strip(False, strip_pass, x, rh, cw, window)


def strip_relayout(x, rh, cw, *, window=6):
    """T1 relayout kernel: x * STRIP_SCALE through the image -> window ->
    image round trip in shared memory."""
    return _strip(True, strip_relayout, x, rh, cw, window)


strip_pass.launches = 0
strip_relayout.launches = 0


def _bmm_exact(a, b):
    """Integer batched product, exact (float64 sums of int8 products)."""
    return torch.bmm(a.double(), b.double())


def window_dots_plain(q, khat, vhat):
    """Twin of T3: per window s = q khat, e = exp2(max(s - rowmax, -100))
    (bf16: rounded to bf16; int8: s scaled by 1/127^2 first, e as
    round(127 e) in int8), out = (e vhat)[:, :, :C] with C q's width (int8:
    scaled by 1/127^2), in bf16."""
    out_cols = q.shape[2]
    if q.dtype == torch.int8:
        s = _bmm_exact(q, khat).float() * INT8_SCALE
        e = torch.exp2(torch.clamp_min(s - s.amax(-1, keepdim=True), -100.0))
        e = torch.round(e * 127.0)
        out = _bmm_exact(e, vhat)[:, :, :out_cols].float() * INT8_SCALE
    else:
        s = torch.bmm(q.float(), khat.float())
        e = torch.exp2(torch.clamp_min(s - s.amax(-1, keepdim=True), -100.0))
        out = torch.bmm(e.to(q.dtype).float(), vhat.float())[:, :, :out_cols]
    return out.to(torch.bfloat16)


def _dot_code(dtype):
    if dtype == torch.bfloat16:
        return _DOT_BF16
    if dtype == torch.int8:
        return _DOT_INT8
    raise TypeError(f"probe takes bfloat16 or int8, not {dtype}")


def _check_dots(what, q, khat, vhat):
    for name, t in (("q", q), ("khat", khat), ("vhat", vhat)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 3-d "
                             f"{q.dtype} on {q.device}")
    nw, n, c = q.shape
    p = khat.shape[2]
    if khat.shape[:2] != (nw, c) or vhat.shape[:2] != (nw, p) or \
            vhat.shape[2] < c:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, khat "
                         f"{tuple(khat.shape)}, vhat {tuple(vhat.shape)}")
    return nw, n, c, p


def window_dots(q, khat, vhat):
    """T3: q (nw, N, C), khat (nw, C, P), vhat (nw, P, Cv >= C) in bf16 or
    int8 -> (nw, N, C) bf16; see ``window_dots_plain``."""
    what = "window_dots"
    if q.device.type == "cpu":
        return window_dots_plain(q, khat, vhat)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    code = _dot_code(q.dtype)
    nw, n, c, p = _check_dots(what, q, khat, vhat)
    if c % 8:
        raise ValueError(f"{what}: C {c} not a multiple of 8")
    out = torch.empty((nw, n, c), dtype=torch.bfloat16, device=q.device)
    rc = _build.library().nunif_window_dots(
        code, q.data_ptr(), khat.data_ptr(), vhat.data_ptr(), out.data_ptr(),
        nw, n, c, p, vhat.shape[2], c, _build.stream_ptr(q.device))
    _build.check(rc, what)
    window_dots.launches += 1
    return out


window_dots.launches = 0


def _wrap_int8(v):
    """int32 -> int8 as a two's-complement cast (wraps)."""
    return ((v + 128) % 256) - 128


def window_dots_repeat_plain(q, khat, vhat):
    """Twin of T4: for each block of BLOCK_WINDOWS windows, REPS times:
    s = q khat; e = bf16(s + carry) (int8: wrap((s + int(carry)) >> 7));
    o = e vhat; carry = carry * 0 + o[block's first window, 0, 0] * 1e-30.
    Returns the last block's carry as an (8, 128) fp32 fill."""
    nb = q.shape[0] // BLOCK_WINDOWS
    carry = torch.zeros(nb, dtype=torch.float32, device=q.device)
    for _ in range(REPS):
        c = carry.repeat_interleave(BLOCK_WINDOWS)[:, None, None]
        if q.dtype == torch.int8:
            s = _bmm_exact(q, khat).long()
            e = _wrap_int8((s + c.to(torch.int32)) >> 7)
            o = _bmm_exact(e, vhat)
        else:
            s = torch.bmm(q.float(), khat.float())
            e = (s + c).to(q.dtype)
            o = torch.bmm(e.float(), vhat.float())
        red = o[::BLOCK_WINDOWS, 0, 0].float()
        carry = carry * 0 + red * 1e-30
    return torch.full((8, 128), float(carry[-1]), dtype=torch.float32,
                      device=q.device)


class PackedDots(NamedTuple):
    """khat^T and vhat^T zero-padded to 32-element multiples of P and C,
    the form T4's kernel reads its B operands in."""
    kt: torch.Tensor  # (nw, roundup(P, 32), roundup(C, 32))
    vt: torch.Tensor  # (nw, C, roundup(P, 32))


def pack_dots(khat, vhat) -> PackedDots:
    nw, c, p = khat.shape
    cp, pp = -(-c // 32) * 32, -(-p // 32) * 32
    kt = khat.new_zeros((nw, pp, cp))
    kt[:, :p, :c] = khat.transpose(1, 2)
    vt = vhat.new_zeros((nw, c, pp))
    vt[:, :, :p] = vhat.transpose(1, 2)
    return PackedDots(kt, vt)


def window_dots_repeat(q, khat, vhat, *, packed=None):
    """T4: q (nw, N, C), khat (nw, C, P), vhat (nw, P, C) in bf16 or int8,
    nw a multiple of BLOCK_WINDOWS -> (8, 128) fp32; see
    ``window_dots_repeat_plain``.  ``packed``, from ``pack_dots(khat,
    vhat)``, saves the per-call re-arrangement."""
    what = "window_dots_repeat"
    if q.device.type == "cpu":
        return window_dots_repeat_plain(q, khat, vhat)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    code = _dot_code(q.dtype)
    nw, n, c, p = _check_dots(what, q, khat, vhat)
    if vhat.shape[2] != c or c % 8 or nw % BLOCK_WINDOWS:
        raise ValueError(f"{what}: vhat {tuple(vhat.shape)}, C {c} (a "
                         f"multiple of 8), {nw} windows in blocks of "
                         f"{BLOCK_WINDOWS}")
    if packed is None:
        packed = pack_dots(khat, vhat)
    out = torch.empty((8, 128), dtype=torch.float32, device=q.device)
    rc = _build.library().nunif_window_dots_repeat(
        code, q.data_ptr(), packed.kt.data_ptr(), packed.vt.data_ptr(),
        out.data_ptr(), nw, n, c, p, REPS, BLOCK_WINDOWS,
        _build.stream_ptr(q.device))
    _build.check(rc, what)
    window_dots_repeat.launches += 1
    return out


window_dots_repeat.launches = 0
