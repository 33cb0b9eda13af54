"""T2 and T4 of two source trees on one card, in turns: the piecewise Swin
block (``ops/probes.py:swin_pieces``) at all ten variants at both shapes of
``tools/microbench_swin_pieces.py`` (C 96, G 4 on 1104x1920; C 192, G 2 on
552x960) and the repeated window dot pair (``window_dots_repeat``) at the
eight shapes of ``tools/microbench_mxu_dots.py`` (1024 windows), with the
tools' own inputs and packed weights.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints ms a case for each run (CUDA
events, median of 3 runs of 5 calls), the medians by tree with each case's
bound (the larger of bytes over 3.35 TB/s and operations over 989 TFLOP/s
bf16 or 1979 TOP/s int8), and whether the trees agree: T4's fills (int8
equal, bf16 rtol 1e-3) and T2's outputs at the card tests' 12x192 (C 96)
and 12x96 (C 192) images with the tool's check weights (max abs difference
0.05, at least 95% bit-equal: the twin's tolerance, since the bf16 sums
run in another order in each tree).  Exits 1 if they do not.

Usage: python -m nunif_tpu_torch.tools.ab_pieces_dots ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``; the T2
outputs of the first run of each tree are kept under ROOT_B's
``build/ab_pieces_dots/`` while the tool runs)
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import sys

T2_ATOL, T2_BIT_EQUAL, T4_RTOL = 0.05, 0.95, 1e-3
CROP = {96: (12, 192), 192: (12, 96)}


def bound_ms(nbytes, ops: dict) -> float:
    peak = {"bfloat16": 989e12, "int8": 1979e12}
    return max(nbytes / 3.35e12, sum(v / peak[k] for k, v in ops.items())) * 1e3


def child(root: str, save: str | None) -> dict:
    """Time T2 and T4 of the tree at ``root``; {case: {"ms", "bound_ms",
    ...}} with T4's fill value; T2's outputs at the small images saved
    under ``save`` when given."""
    sys.path.insert(0, root)
    import torch
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.tools import microbench_mxu_dots as t4
    from nunif_tpu_torch.tools import microbench_swin_pieces as t2
    from nunif_tpu_torch.tools import time_ms
    assert probes.__file__ == os.path.join(root, "nunif_tpu_torch", "ops",
                                           "probes.py"), probes.__file__
    out = {}
    for c in (96, 192):
        g = t2.default_g(c)
        x = t2.image(c)
        h, w = t2.shape(c)
        xc = t2.image(c, *CROP[c], seed=c + 1)
        for name in t2.VARIANTS:
            v = t2.variant(name)
            wts = t2.weights(c, g, v["dense_int8"])
            packed = probes.pack_pieces(*wts[:8], *wts[9:], dense_int8=v["dense_int8"])
            kw = dict(G=g, rh=t2.RH, cw=t2.default_cw(c), **v)
            nbytes, ops = t2.work(c, h, w, g, name)
            ms = time_ms(lambda: probes.swin_pieces(x, *wts, packed=packed, **kw), 5)
            chk = t2.weights(c, g, v["dense_int8"], check=True, seed=c)
            y = probes.swin_pieces(xc, *chk, **kw)
            torch.cuda.synchronize()
            key = f"T2 C={c} {name}"
            if save:
                torch.save(y.cpu(), os.path.join(save, f"{key}.pt"))
            out[key] = dict(ms=ms, bound_ms=bound_ms(nbytes, ops))
            del wts, packed, chk, y
            torch.cuda.empty_cache()
        del x, xc
    for label, n, c, p, int8 in t4.SHAPES:
        q, khat, vhat = t4.inputs(n, c, p, int8)
        packed = probes.pack_dots(khat, vhat)
        fill = probes.window_dots_repeat(q, khat, vhat, packed=packed)
        ms = time_ms(lambda: probes.window_dots_repeat(q, khat, vhat, packed=packed), 5)
        nw = q.shape[0]
        nbytes = sum(t.numel() * t.element_size() for t in (q, khat, vhat)) + 8 * 128 * 4
        flops = 2 * 2 * n * c * p * probes.REPS * nw
        out[f"T4 {label}"] = dict(
            ms=ms, bound_ms=bound_ms(nbytes, {"int8" if int8 else "bfloat16": flops}),
            fill=float(fill[0, 0]), int8=int8)
        del q, khat, vhat, packed
        torch.cuda.empty_cache()
    return out


def main(root_a: str, root_b: str) -> int:
    import torch
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    save_dir = os.path.join(root_b, "build", "ab_pieces_dots")
    saved = {"A": os.path.join(save_dir, "a"), "B": os.path.join(save_dir, "b")}
    for d in saved.values():
        os.makedirs(d, exist_ok=True)
    try:
        return compare(torch, run_turns(
            __file__, root_a, root_b, {"T2 C=96 P4": 1},
            lambda label, turn: [saved[label]] if turn < 2 else []), saved)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def compare(torch, runs, saved) -> int:
    keys = list(runs[0][1])
    ok = True
    for k in keys:
        bnd = runs[0][1][k]["bound_ms"]
        med = {lab: statistics.median(s[k]["ms"] for l2, s, _f in runs if l2 == lab)
               for lab in ("A", "B")}
        line = (f"{k}: A {med['A']:.4f} B {med['B']:.4f} ms (B/A {med['B'] / med['A']:.3f}), "
                f"bound {bnd:.4f} ms (A {100 * bnd / med['A']:.1f}%, "
                f"B {100 * bnd / med['B']:.1f}%)")
        ra, rb = runs[0][1][k], runs[1][1][k]
        if k.startswith("T2"):
            a, b = (torch.load(os.path.join(saved[lab], f"{k}.pt")).float()
                    for lab in ("A", "B"))
            d = (a - b).abs()
            err, same = float(d.max()), float((d == 0).float().mean())
            good = err <= T2_ATOL and same >= T2_BIT_EQUAL
            line += f"; small image A vs B: max abs {err:.4g}, bit-equal {same:.4f}"
        else:
            fa, fb = ra["fill"], rb["fill"]
            good = fa == fb if ra["int8"] else abs(fa - fb) <= T4_RTOL * abs(fa)
            line += f"; fills A {fa!r} B {fb!r}"
        ok &= good
        print(line + ("" if good else "  DIFFER beyond tolerance"), flush=True)
    print(f"T2 / T4 outputs of the two trees agree at all {len(keys)} cases: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2],
                               sys.argv[3] if len(sys.argv) > 3 else None)))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
