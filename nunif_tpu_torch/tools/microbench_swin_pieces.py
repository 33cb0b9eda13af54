"""T2 on the card: the Swin block cut after each piece, bf16 against W8A8
int8 dense layers and int8 scores (the question of
``tools/microbench_swin_pieces.py``).

Draws the JAX tool's inputs with numpy from its seeds (x ~ N(0, 0.5) from
seed 1; weights ~ N(0, 0.05), their per-column int8 quantization, zero
biases and an N(0, 0.02) bias table from seed 0), moves them to the card
and times ``ops/probes.py:swin_pieces`` per variant at the tool's shapes: C
= 96, G = 4 on a 1104x1920 image, or C = 192, G = 2 on 552x960, blocks of
1 x max(8, 1536 / C) windows.  Prints ms a layer beside the plain twin and,
for P4 and P0q, the composite a PyTorch user would write (cuBLAS
``F.linear``, SDPA per head with the bias as a float mask, or
``torch._int_mm``).

Usage: python -m nunif_tpu_torch.tools.microbench_swin_pieces [C] [G] [pieces...]
"""
from __future__ import annotations

import math
import sys

import numpy as np

from . import require_cuda, time_ms

VARIANTS = {
    "W": dict(pieces=-1),
    "P0": dict(pieces=0),
    "P1": dict(pieces=1),
    "P2": dict(pieces=2),
    "P3": dict(pieces=3),
    "P4": dict(pieces=4),
    "P0q": dict(pieces=0, dense_int8=True),
    "P4q": dict(pieces=4, dense_int8=True),
    "P4s": dict(pieces=4, scores_int8=True),
    "P4qs": dict(pieces=4, dense_int8=True, scores_int8=True),
}
DEFAULT = ("W", "P0", "P2", "P4")
N = 36
RH = 1


def shape(c):
    """(H, W) of the tool's image at width C."""
    return (1104, 1920) if c == 96 else (552, 960)


def default_g(c):
    return 4 if c == 96 else 2


def default_cw(c):
    return max(8, 1536 // c)


def variant(name):
    return dict(dict(dense_int8=False, scores_int8=False), **VARIANTS[name])


def image(c, h=None, w=None, seed=1, device="cuda"):
    """x as the tool draws it: N(0, 0.5) from numpy, in bf16."""
    import torch
    if h is None:
        h, w = shape(c)
    x = np.random.default_rng(seed).normal(0, 0.5, (1, h, w, c))
    return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)


def weights(c, g, dense_int8, *, check=False, seed=0, device="cuda"):
    """The tool's arguments after x, in its order (wqkv, bqkv, wproj, bproj,
    wfc1, bfc1, wfc2, bfc2, bias, sqkv, sproj, sfc1, sfc2), drawn as its
    ``build`` draws them: weights N(0, 0.05) from numpy seed 0, quantized
    per column for W8A8, zero biases, ones for unused scales, the bias table
    N(0, 0.02).  ``check``: weights N(0, 1 / fan-in), biases N(0, 0.1) and
    the bias table N(0, 1), so that a comparison sees every term."""
    import torch
    rng = np.random.default_rng(seed)
    heads, hid = c // 16, 2 * c

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    def mkw(i, o):
        w = rng.normal(0, 1 / np.sqrt(i) if check else 0.05, (i, o)).astype(np.float32)
        b = rng.normal(0, 0.1, (o,)) if check else np.zeros((o,))
        if not dense_int8:
            return t(w, torch.bfloat16), t(b), t(np.ones((o,)))
        s = np.abs(w).max(0) / 127.0
        return t(np.round(w / s[None]).astype(np.int8), torch.int8), t(b), t(s)

    layers = [mkw(c, 3 * c), mkw(c, c), mkw(c, hid), mkw(hid, c)]
    bias = t(rng.normal(0, 1.0 if check else 0.02, (g * N, heads * g * N)))
    return [a for w, b, _s in layers for a in (w, b)] + [bias] + \
        [s for _w, _b, s in layers]


def work(c, h, w, g, name):
    """Bytes the function must move (x in, out, weights, tables) and its
    tensor-core operations by type, at these shapes."""
    v = variant(name)
    tokens = h * w
    nbytes = 2 * tokens * c * 2
    ops = {"bfloat16": 0.0, "int8": 0.0}
    if v["pieces"] >= 0:
        heads = c // 16
        nbytes += 8 * c * c * (1 if v["dense_int8"] else 2) \
            + (g * N) ** 2 * heads * 4
        ops["int8" if v["dense_int8"] else "bfloat16"] += 16 * tokens * c * c
    attn = 2 * tokens * g * N * c  # one product: scores or P V
    if v["pieces"] >= 2:
        ops["int8" if v["scores_int8"] else "bfloat16"] += attn
    if v["pieces"] >= 4:
        ops["bfloat16"] += attn
    return nbytes, ops


def library_call(x, wts, g, name, rh, cw):
    """The composite a PyTorch user would write for P4 (bf16: window
    partition, cuBLAS F.linear, SDPA per head with bias * ln 2 as a float
    mask and scale 16^-0.5, which is the tool's exp2 softmax) or P0q
    (torch._int_mm W8A8); None for the other variants, or without
    torch._int_mm."""
    import torch
    import torch.nn.functional as F
    from ..ops import probes
    if name not in ("P4", "P0q") or (name == "P0q" and not hasattr(torch, "_int_mm")):
        return None
    wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, bias, *scales = wts
    _b, h, w, c = x.shape
    heads, ng, dt = c // 16, g * N, torch.bfloat16
    if name == "P4":
        mats = [m.t().contiguous() for m in (wqkv, wproj, wfc1, wfc2)]
        bs = [b.to(dt) for b in (bqkv, bproj, bfc1, bfc2)]
        mask = (bias * math.log(2)).reshape(ng, heads, ng).permute(1, 0, 2) \
            .contiguous().to(dt)

        def linear(a, i):
            return F.linear(a, mats[i], bs[i])
    else:
        def linear(a, i):
            aq, sa = probes.quant_rows(a)
            y = torch._int_mm(aq, (wqkv, wproj, wfc1, wfc2)[i]).float()
            return (y * sa * scales[i] + (bqkv, bproj, bfc1, bfc2)[i]).to(dt)

    def call():
        xw = probes.pieces_windows(x, rh, cw).reshape(-1, c)
        qkv = linear(xw, 0)
        if name == "P4":
            q, k, v = qkv.view(-1, ng, 3, heads, 16).permute(2, 0, 3, 1, 4)
            a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=0.25)
            a = a.transpose(1, 2).reshape(-1, c)
        else:
            a = qkv[:, :c] * 0.001
        y1 = linear(a, 1) + xw
        hh = linear(y1, 2)
        out = linear(torch.sigmoid(1.702 * hh) * hh, 3) + y1
        return probes.pieces_unwindows(out, rh, cw, h, w)
    return call


def bench(c, g, name, x, rh=RH, cw=None, iters=5) -> dict:
    import torch
    from ..ops import probes
    cw = cw or default_cw(c)
    v = variant(name)
    wts = weights(c, g, v["dense_int8"])
    packed = probes.pack_pieces(*wts[:8], *wts[9:], dense_int8=v["dense_int8"])
    kw = dict(G=g, rh=rh, cw=cw, **v)
    ms = time_ms(lambda: probes.swin_pieces(x, *wts, packed=packed, **kw), iters)
    plain = time_ms(lambda: probes.swin_pieces_plain(x, *wts, **kw), 1, rounds=1)
    lib_fn = library_call(x, wts, g, name, rh, cw)
    lib = None if lib_fn is None else time_ms(lib_fn, iters)
    torch.cuda.empty_cache()
    print(f"  {name:5s}: {ms:7.3f} ms/layer  plain twin {plain:8.2f} ms  "
          f"library {'none' if lib is None else f'{lib:.3f} ms'}", flush=True)
    _b, h, w, _c = x.shape
    nbytes, ops = work(c, h, w, g, name)
    return dict(name=name, C=c, G=g, ms=ms, plain_ms=plain, library_ms=lib,
                nbytes=nbytes, ops=ops)


def run(c=96, g=None, select=DEFAULT) -> list:
    g = g or default_g(c)
    h, w = shape(c)
    print(f"devices: {require_cuda()}; C={c} G={g} H={h} W={w} rh={RH} "
          f"cw={default_cw(c)}", flush=True)
    x = image(c)
    return [bench(c, g, name, x) for name in select]


if __name__ == "__main__":
    c = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    g = int(sys.argv[2]) if len(sys.argv) > 2 else None
    run(c, g, sys.argv[3:] or DEFAULT)
