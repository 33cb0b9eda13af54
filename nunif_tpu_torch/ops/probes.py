"""Hopper probes T1-T4: the questions of the JAX package's
``tools/microbench_*`` Pallas probes, asked of the H100.

T1 ``strip_pass`` / ``strip_relayout``: replaces
``tools/microbench_strip.py:strip_call`` (kernels ``_pass_kernel``,
``_relayout_kernel``).  x * scale on a bf16 image, streamed, or through a
strip <-> window relayout in shared memory (``csrc/probe_strip.cu``).

T3 ``window_dots``: replaces ``tools/microbench_int8_attn.py:bench``
(``_kernel_bf16``, ``_kernel_int8``).  Per window the dot pair of
head-packed attention with exp2 between, bf16 or int8, streamed from
device memory by bulk copies into a ring (``csrc/probe_window_ring.cu``).

T4 ``window_dots_repeat``: replaces ``tools/microbench_mxu_dots.py:bench``
(``_mk_kernel``).  The dot pair repeated on resident operands with a data
dependency, on wgmma in bf16 and int8 (``csrc/probe_window_dots.cu``).

T2 ``swin_pieces``: replaces ``tools/microbench_swin_pieces.py:build``
(``_kernel``).  A whole Swin block on groups of G windows, cut after each
piece, with W8A8 int8 dense layers and int8 scores, on wgmma in bf16 and
int8 (``csrc/probe_swin_pieces.cu``).  Its roundings follow the tool as XLA
compiles it (``quant_rows``), which the CPU tests hold it to bit for bit.

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
    """Integer (batched) product, exact (float64 sums of int8 products)."""
    return torch.matmul(a.double(), b.double())


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
    int8 -> (nw, N, C) bf16; see ``window_dots_plain``.  The kernel takes
    N <= 48, C <= 240 and a multiple of 8 (C % 16 in int8: rows of q of
    whole 16-byte units), P <= 256; in bf16 P and Cv multiples of 8 up to
    248 (a TMA box is at most 256 wide), in int8 multiples of 4 with each
    window of khat and vhat a multiple of 16 bytes; 16-byte aligned
    operands (its bulk copies)."""
    what = "window_dots"
    if q.device.type == "cpu":
        return window_dots_plain(q, khat, vhat)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    code = _dot_code(q.dtype)
    nw, n, c, p = _check_dots(what, q, khat, vhat)
    cv, es = vhat.shape[2], q.element_size()
    if es == 2:  # bf16: B rows read by ldmatrix, padded ones by a TMA box
        rows = p % 8 == 0 and cv % 8 == 0 and p <= 248 and cv <= 248
    else:  # int8: rows read by words, windows by bulk copy
        rows = p % 4 == 0 and cv % 4 == 0 and (c * p) % 16 == 0 and \
            (p * cv) % 16 == 0
    if c % 8 or n > 48 or c > 240 or p > 256 or (c * es) % 16 or not rows:
        raise ValueError(f"{what}: N {n}, C {c}, P {p}, Cv {cv} in {q.dtype}: "
                         f"not a shape the kernel takes")
    if any(t.data_ptr() % 16 for t in (q, khat, vhat)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
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


def window_dots_repeat_plain(q, khat, vhat, check=None):
    """Twin of T4: for each block of BLOCK_WINDOWS windows, REPS times:
    s = q khat; e = bf16(s + carry) (int8: wrap((s + int(carry)) >> 7));
    o = e vhat; carry = carry * 0 + o[block's first window, 0, 0] * 1e-30.
    Returns the last block's carry as an (8, 128) fp32 fill; ``check``, an
    (nw, N, C) fp32 tensor, receives each window's o of the last
    repetition."""
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
    if check is not None:
        check.copy_(o.float())
    return torch.full((8, 128), float(carry[-1]), dtype=torch.float32,
                      device=q.device)


class DotsPlan(NamedTuple):
    """T4's plan for one shape, from the library (``dot_plan`` in
    ``csrc/probe_window_dots.cu``): the pack's widths -- kp (C as the
    first product's K), cn (C as the second product's N), pc (P's chunk),
    nch (chunks) -- and, with N, the split of a block's 16 windows over a
    cluster of two blocks (psplit 1: 8 windows each; 2: every window, half
    the chunks each), the 64-row tiles of a window, the ring's stages, a
    stage's and the block's shared-memory bytes (0 without N)."""
    kp: int
    cn: int
    pc: int
    nch: int
    psplit: int = 0
    mtiles: int = 0
    stages: int = 0
    stage_bytes: int = 0
    smem: int = 0


def window_dots_plan(dtype, n, c, p) -> DotsPlan:
    """The library's plan for T4 at N tokens (0: the pack's widths only),
    width C and P (card only: it loads the built library)."""
    import ctypes
    out = (ctypes.c_int * 9)()
    _build.check(_build.library().nunif_window_dots_plan(
        _dot_code(dtype), n, c, p, out), "window_dots_plan")
    return DotsPlan(*out) if n else DotsPlan(*out[:4])


# int8 e enters the second product in the accumulator's column order: k
# slot 4 t + i of each 16 holds column 8 (i // 2) + 2 t + i % 2, so vhat's
# rows are ordered the same way within each block of 32
_S8_ORDER = [16 * (s // 16) + 8 * ((s % 4) // 2) + 2 * ((s % 16) // 4) + s % 2
             for s in range(32)]


def _planes(x, width, e):
    """(..., rows, cols) -> (..., width / e, rows, e): cols zero-padded to
    width, cut into planes of e columns (16 bytes a row), each plane's rows
    contiguous: wgmma's K-major core matrices."""
    if x.shape[-1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    *lead, rows, _cols = x.shape
    return x.reshape(*lead, rows, width // e, e).transpose(-3, -2).contiguous()


class PackedDots(NamedTuple):
    """khat^T and vhat^T in P chunks of planes, the form T4's kernel copies
    into shared memory (``pack_dots``)."""
    layout: DotsPlan
    kt: torch.Tensor  # (nw, nch, kp / E, pc, E), E values = 16 bytes
    vt: torch.Tensor  # (nw, nch, pc / E, cn, E)


def pack_dots(khat, vhat, layout=None) -> PackedDots:
    """khat (nw, C, P), vhat (nw, P, C) -> ``PackedDots``: P zero-padded to
    nch chunks of pc; kt[w, ch, pl, r, e] = khat[w, E pl + e, pc ch + r]
    (C zero-padded to kp), vt[w, ch, pl, n, e] = vhat[w, pc ch + k(E pl +
    e), n] (C zero-padded to cn) with k the identity in bf16 and, in int8,
    the column order of e within each 32 (``_S8_ORDER``).  ``layout``:
    the plan's widths (default: the library's)."""
    nw, c, p = khat.shape
    if layout is None:
        layout = window_dots_plan(khat.dtype, 0, c, p)
    e = 16 // khat.element_size()
    pp = layout.nch * layout.pc
    kt = torch.nn.functional.pad(khat.transpose(1, 2), (0, 0, 0, pp - p))
    kt = _planes(kt.reshape(nw, layout.nch, layout.pc, c), layout.kp, e)
    vt = torch.nn.functional.pad(vhat, (0, layout.cn - c, 0, pp - p))
    if khat.dtype == torch.int8:
        idx = torch.arange(pp, device=vt.device)
        order = torch.tensor(_S8_ORDER, device=vt.device)
        vt = vt[:, idx // 32 * 32 + order[idx % 32]]
    vt = _planes(vt.reshape(nw, layout.nch, layout.pc, layout.cn).transpose(-1, -2),
                 layout.pc, e)
    return PackedDots(layout, kt, vt)


def window_dots_repeat(q, khat, vhat, *, packed=None, check=None):
    """T4: q (nw, N, C), khat (nw, C, P), vhat (nw, P, C) in bf16 or int8,
    nw a multiple of BLOCK_WINDOWS -> (8, 128) fp32; see
    ``window_dots_repeat_plain``.  ``packed``, from ``pack_dots(khat,
    vhat)``, saves the per-call re-arrangement of khat and vhat (q is laid
    into planes on every call).  ``check``, an (nw, N, C) fp32 tensor,
    receives each window's o of the last repetition (a test hook).  The
    kernel takes N <= 128 and C <= 128."""
    what = "window_dots_repeat"
    if q.device.type == "cpu":
        return window_dots_repeat_plain(q, khat, vhat, check)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    code = _dot_code(q.dtype)
    nw, n, c, p = _check_dots(what, q, khat, vhat)
    if vhat.shape[2] != c or nw % BLOCK_WINDOWS or n > 128 or c > 128:
        raise ValueError(f"{what}: vhat {tuple(vhat.shape)}, N {n}, C {c} "
                         f"(at most 128), {nw} windows in blocks of "
                         f"{BLOCK_WINDOWS}")
    if check is not None and (check.shape != (nw, n, c) or check.dtype != torch.float32
                              or check.device != q.device or not check.is_contiguous()):
        raise ValueError(f"{what}: check must be a contiguous ({nw}, {n}, {c}) "
                         f"fp32 tensor on {q.device}")
    if packed is None:
        packed = pack_dots(khat, vhat)
    qp = _planes(q, packed.layout.kp, 16 // q.element_size())
    out = torch.empty((8, 128), dtype=torch.float32, device=q.device)
    if check is not None:
        check.zero_()
    rc = _build.library().nunif_window_dots_repeat(
        code, qp.data_ptr(), packed.kt.data_ptr(), packed.vt.data_ptr(),
        out.data_ptr(), 0 if check is None else check.data_ptr(), nw, n, c, p,
        REPS, BLOCK_WINDOWS, _build.stream_ptr(q.device))
    _build.check(rc, what)
    window_dots_repeat.launches += 1
    return out


window_dots_repeat.launches = 0


# ---- T2 --------------------------------------------------------------------

PIECES_WINDOW, PIECES_TOKENS, PIECES_HEAD_DIM = 6, 36, 16
LOG2E = 1.4426950408889634
# the tool's constants, as its bf16 arithmetic rounds them (weak-typed
# Python floats take the array's dtype): 1.0001 -> 1.0, 0.001, 1e-6, 1/127
_W_SCALE, _CUT, _EPS, _INV127 = 1.0001, 0.001, 1e-6, 1.0 / 127.0
_PIECES_CHUNK = 2048  # groups a twin step computes (bounds its memory)


def _bf(v):
    """A Python float rounded to bf16, as a float."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def quant_rows(x):
    """Per-row symmetric int8 quantization of bf16 rows, as the tool's
    ``_quant_rows`` runs once XLA has compiled it: amax and max(amax, 1e-6)
    are bf16 values, but r = 127 / amax and the scale amax * bf16(1 / 127)
    stay fp32 (XLA's excess precision drops their bf16 roundings); x * r
    runs in fp32 and rounds half to even.  Returns (xq int8, scale fp32
    (..., 1)); the tool returns the scale rounded to bf16, and its dense
    layers use it unrounded."""
    amax = torch.clamp_min(x.abs().amax(-1, keepdim=True).float(), _bf(_EPS))
    r = torch.div(torch.full_like(amax, 127.0), amax)  # not 127 * (1 / amax)
    xq = torch.round(x.float() * r).to(torch.int8)
    return xq, amax * _bf(_INV127)


def _pieces_dense(a, w, b, s, dense_int8):
    """The tool's ``_dense``: fp32 (a W + b); W8A8: a quantized per row,
    y = f32(int32 acc) * row scale * column scale + b."""
    if not dense_int8:
        return a.float() @ w.float() + b.float()
    aq, sa = quant_rows(a)
    return (_bmm_exact(aq, w).float() * sa) * s.float() + b.float()


def pieces_windows(x, rh, cw):
    """(1, H, W, C) -> (windows, 36, C): blocks of rh x cw windows in
    row-major order, windows row-major inside a block, tokens row-major
    inside a window (the tool kernel's window order)."""
    _b, h, w, c = x.shape
    ws = PIECES_WINDOW
    return x.reshape(h // (rh * ws), rh, ws, w // (cw * ws), cw, ws, c) \
        .permute(0, 3, 1, 4, 2, 5, 6).reshape(-1, ws * ws, c)


def pieces_unwindows(t, rh, cw, h, w):
    """The inverse of ``pieces_windows``."""
    ws, c = PIECES_WINDOW, t.shape[-1]
    return t.reshape(h // (rh * ws), w // (cw * ws), rh, cw, ws, ws, c) \
        .permute(0, 2, 4, 1, 3, 5, 6).reshape(1, h, w, c)


def _pieces_groups(xg, mats, biases, scales, bias, *, pieces, dense_int8,
                   scores_int8):
    """The tool kernel on token groups xg (nb, G N, C) bf16."""
    dt = torch.bfloat16
    nb, ng, c = xg.shape
    hd = PIECES_HEAD_DIM
    heads = c // hd
    xt = xg.reshape(nb * ng, c)

    def dense(a, i):
        return _pieces_dense(a, mats[i], biases[i], scales[i], dense_int8)

    qkv = dense(xt, 0).to(dt).reshape(nb, ng, 3 * c)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    cut = torch.tensor(_CUT, dtype=dt)
    if pieces >= 2:
        # scores[t, h NG + s] = sum over head h's lanes of bf16(q scale) k
        qs = q * torch.tensor(hd ** -0.5 * LOG2E, dtype=dt)
        kh = k.reshape(nb, ng, heads, hd)
        if scores_int8:
            # here the compiled tool keeps its quantizer's bf16 scales
            qq, sq = quant_rows(qs)
            kq, sk = quant_rows(kh)
            si = torch.einsum("btha,bsha->bths", qq.reshape(nb, ng, heads, hd)
                              .double(), kq.double()).float()
            sq, sk = (s.to(dt).float() for s in (sq, sk))
            scores = (si * sq[..., None]) * sk[..., 0].permute(0, 2, 1)[:, None]
        else:
            scores = torch.einsum("btha,bsha->bths",
                                  qs.float().reshape(nb, ng, heads, hd),
                                  kh.float())
        scores = scores.reshape(nb, ng, heads * ng)
    if pieces >= 3:
        e = torch.exp2(torch.clamp(scores + bias.float(), -100.0, 60.0)).to(dt)
    if pieces >= 4:
        e4 = e.float().reshape(nb, ng, heads, ng)
        num = torch.einsum("bths,bsha->btha", e4,
                           v.float().reshape(nb, ng, heads, hd))
        attn = (num / e4.sum(-1, keepdim=True)).reshape(nb, ng, c).to(dt)
    elif pieces == 3:
        attn = e[..., :c] * cut
    elif pieces == 2:
        attn = (scores[..., :c] * _CUT).to(dt)
    elif pieces == 1:
        head0 = torch.zeros(c, dtype=dt)
        head0[:hd] = 1
        attn = (k + v) * head0.to(xg.device) * cut
    else:
        attn = q * cut
    attn = attn.reshape(nb * ng, c)
    y1 = (dense(attn, 1) + xt.float()).to(dt)
    h1 = dense(y1, 2)
    h1 = (torch.sigmoid(1.702 * h1) * h1).to(dt)
    out = (dense(h1, 3) + y1.float()).to(dt)
    return out.reshape(nb, ng, c)


def swin_pieces_plain(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
                      bias, sqkv, sproj, sfc1, sfc2, *, G, rh, cw, pieces,
                      dense_int8=False, scores_int8=False):
    """Twin of T2: the tool kernel's piecewise Swin block on a bf16 image
    (1, H, W, C), window 6, heads C / 16, in groups of G consecutive windows
    of each block of rh x cw windows (``pieces_windows``).

    pieces -1 (W): x * bf16(1.0001), a copy.  Otherwise qkv = bf16(x Wqkv),
    then the attention cut after piece ``pieces`` (0: q; 1: k + v on head
    0's lanes; 2: the scores; 3: e = bf16(exp2(clip(scores + bias, -100,
    60)))), each consumed as bf16(t * 0.001), or whole (4: attention over
    all G N tokens of the group per head, no max subtraction, fp32 sums of
    the bf16 e), then y1 = bf16(attn Wproj + x), h1 = bf16(sigmoid(1.702 h)
    h) for h = y1 Wfc1, out = bf16(h1 Wfc2 + y1).  ``dense_int8``: W8A8
    dense layers (int8 weights with per-column scales ``s*``);
    ``scores_int8``: the scores from per-row int8 q (all C lanes) and khat
    (one head's lanes).  ``bias`` is (G N, heads G N) fp32."""
    dt = torch.bfloat16
    _b, h, w, c = x.shape
    if pieces < 0:
        return (x * torch.tensor(_W_SCALE, dtype=dt).to(x.device)).to(dt)
    mats = (wqkv, wproj, wfc1, wfc2)
    biases = (bqkv, bproj, bfc1, bfc2)
    scales = (sqkv, sproj, sfc1, sfc2)
    ng = G * PIECES_TOKENS
    xg = pieces_windows(x, rh, cw).reshape(-1, ng, c)
    out = torch.cat([_pieces_groups(
        xg[i:i + _PIECES_CHUNK], mats, biases, scales, bias, pieces=pieces,
        dense_int8=dense_int8, scores_int8=scores_int8)
        for i in range(0, xg.shape[0], _PIECES_CHUNK)])
    return pieces_unwindows(out, rh, cw, h, w)


def pieces_chunk_width(c):
    """Columns of T2's weight chunks at width C: each warpgroup takes every
    other chunk, so a layer's widths (3C, C, 2C) hold an even number --
    96 where C is a multiple of 192, 48 of 96, else 16 (the library's plan,
    ``swin_pieces_plan``, says the same)."""
    return 96 if c % 192 == 0 else 48 if c % 96 == 0 else 16


class PiecesPlan(NamedTuple):
    """T2's plan from the library (``pieces_plan`` in
    ``csrc/probe_swin_pieces.cu``): a tile is one group of ``rows`` = G 36
    token rows in ``mtiles`` 64-row tiles; the weights come in chunks of
    ``nc`` columns, ``kper`` k steps a stage of ``wstages``; the bias table
    in stages of 64 rows of one head's slice (``bstages``), rows
    ``bstride`` fp32 apart; ``smem`` bytes a block."""
    rows: int
    mtiles: int
    nc: int
    kper: int
    wstages: int
    bstages: int
    bstride: int
    smem: int


def swin_pieces_plan(c, g) -> PiecesPlan:
    """The library's plan for T2 at width C and G windows a group (card
    only: it loads the built library); raises ValueError for shapes the
    kernel is not built for (C 32, 96, 192 at G 2, 4, 2, and any C with
    the same chunk width and tile count)."""
    import ctypes
    out = (ctypes.c_int * 8)()
    if _build.library().nunif_swin_pieces_plan(c, g, out) != 0:
        raise ValueError(f"swin_pieces: C {c}, G {g}: not a shape the kernel "
                         "takes (built for C 32 / 96 / 192 at G 2 / 4 / 2)")
    return PiecesPlan(*out)


class PackedPieces(NamedTuple):
    """T2's dense weights as the kernel reads them: qkv, proj, fc1, fc2 in
    wgmma's K-major B layout in chunks of ``nc`` columns
    (``_build.wgmma_weight_layout``; bf16, or int8 for W8A8), their fp32
    biases and fp32 per-column weight scales."""
    dense_int8: bool
    nc: int
    mats: tuple
    biases: tuple
    scales: tuple


def pack_pieces(wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, sqkv,
                sproj, sfc1, sfc2, *, dense_int8) -> PackedPieces:
    """Arrange T2's weights for the kernel once; pass the result as
    ``packed=`` so that calls skip this work (the tool keeps its weights
    resident, too)."""
    dt = torch.int8 if dense_int8 else torch.bfloat16
    nc = pieces_chunk_width(wqkv.shape[0])
    return PackedPieces(
        dense_int8, nc,
        tuple(_build.wgmma_weight_layout(w.to(dt).contiguous(), nc)
              for w in (wqkv, wproj, wfc1, wfc2)),
        tuple(b.float().contiguous() for b in (bqkv, bproj, bfc1, bfc2)),
        tuple(s.float().contiguous() for s in (sqkv, sproj, sfc1, sfc2)))


def pack_bias(bias, c, g, stride):
    """The (G N, heads G N) bias table head-major, (heads, G N, stride)
    fp32 with each row zero-padded to ``stride``: a 64-row slice of one
    head is one contiguous copy."""
    ng, heads = g * PIECES_TOKENS, c // PIECES_HEAD_DIM
    t = bias.float().reshape(ng, heads, ng).permute(1, 0, 2)
    return torch.nn.functional.pad(t, (0, stride - ng)).contiguous()


def _check_pieces(what, x, weights, bias, G, rh, cw, pieces, dense_int8,
                  scores_int8):
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[0] != 1 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be a contiguous 16-byte aligned "
                         f"bf16 (1, H, W, C), got {x.dtype} {tuple(x.shape)}")
    _b, h, w, c = x.shape
    ws, n = PIECES_WINDOW, PIECES_TOKENS
    if c % 32 or G < 1 or rh < 1 or cw < 1 or (rh * cw) % G \
            or h % (rh * ws) or w % (cw * ws):
        raise ValueError(f"{what}: {h}x{w}x{c} with blocks of {rh}x{cw} "
                         f"windows of {ws} in groups of {G} (C a multiple of "
                         "32, G dividing rh * cw)")
    if pieces not in (-1, 0, 1, 2, 3, 4):
        raise ValueError(f"{what}: pieces {pieces} not in -1 .. 4")
    if scores_int8 and pieces in (2, 3):
        raise ValueError(f"{what}: int8 scores are built for pieces 4 "
                         f"(the tool's P4s, P4qs), not {pieces}")
    hid, heads = 2 * c, c // PIECES_HEAD_DIM
    expect = {"wqkv": (c, 3 * c), "bqkv": (3 * c,), "wproj": (c, c),
              "bproj": (c,), "wfc1": (c, hid), "bfc1": (hid,),
              "wfc2": (hid, c), "bfc2": (c,), "sqkv": (3 * c,),
              "sproj": (c,), "sfc1": (hid,), "sfc2": (c,),
              "bias": (G * n, heads * G * n)}
    wdt = torch.int8 if dense_int8 else torch.bfloat16
    for name, t in zip(expect, (*weights, bias)):
        if tuple(t.shape) != expect[name] or t.device != x.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on {t.device}"
                             f" != {expect[name]} on {x.device}")
        if name.startswith("w") and t.dtype != wdt:
            raise ValueError(f"{what}: {name} is {t.dtype}, not {wdt}")


def swin_pieces(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, bias,
                sqkv, sproj, sfc1, sfc2, *, G, rh, cw, pieces,
                dense_int8=False, scores_int8=False, packed=None):
    """T2: the tool kernel's piecewise Swin block on x (1, H, W, C) bf16,
    arguments in the tool's order: weights (in, out) in bf16, or int8 with
    ``dense_int8``; biases, scales and ``bias`` (G 36, heads G 36) fp32; see
    ``swin_pieces_plain``.  ``packed``, from ``pack_pieces``, saves the
    per-call re-arrangement of the weights (the bias table is laid out
    head-major on every call).  The kernel takes the shapes of
    ``swin_pieces_plan`` and int8 scores at pieces 4 only.  Returns (1, H,
    W, C) bf16."""
    what = "swin_pieces"
    weights = (wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2)
    scales = (sqkv, sproj, sfc1, sfc2)
    kw = dict(G=G, rh=rh, cw=cw, pieces=pieces, dense_int8=dense_int8,
              scores_int8=scores_int8)
    if x.device.type == "cpu":
        return swin_pieces_plain(x, *weights, bias, *scales, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check_pieces(what, x, weights + scales, bias, G, rh, cw, pieces,
                  dense_int8, scores_int8)
    _b, h, w, c = x.shape
    plan = swin_pieces_plan(c, G)
    if packed is None:
        packed = pack_pieces(*weights, *scales, dense_int8=dense_int8)
    elif packed.dense_int8 != dense_int8 or packed.nc != plan.nc:
        raise ValueError(f"{what}: weights packed for dense_int8="
                         f"{packed.dense_int8} in chunks of {packed.nc}")
    ptrs = []
    for i in range(4):
        ptrs += [t.data_ptr() for t in (packed.mats[i], packed.biases[i],
                                        packed.scales[i])]
    bias = pack_bias(bias, c, G, plan.bstride)
    out = torch.empty_like(x)
    rc = _build.library().nunif_swin_pieces(
        x.data_ptr(), *ptrs, bias.data_ptr(), out.data_ptr(), h, w, c, G, rh,
        cw, pieces, int(dense_int8), int(scores_int8), _bf(_W_SCALE),
        _bf(_CUT), _bf(PIECES_HEAD_DIM ** -0.5 * LOG2E), _bf(_EPS),
        _bf(_INV127), _build.stream_ptr(x.device))
    _build.check(rc, what)
    swin_pieces.launches += 1
    return out


swin_pieces.launches = 0
