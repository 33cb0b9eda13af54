"""T1 of two source trees on one card, in turns: the pass and relayout
kernels (``ops/probes.py:strip_pass`` / ``strip_relayout``) at the (rh,
cw) window blocks of ``tools/microbench_strip.py`` that tile its bf16 (1,
1104, 1920, 96) image (five of seven: 184 window rows are no multiple of
16), seeded on the card.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints ms a call for each kernel and
block in each run (the wrapper as a caller calls it, CUDA events around 30
calls, median and least of 5 rounds), the medians by tree with the share of
the bound (x read once, the output written once, at 3.35 TB/s), and
whether every output is the same in every run of both trees: a sha1 of the
output at the tool's scale (1.0 in bf16, so the output is x) and at scale
2.0 (exact in bf16, so the scale shows).  Exits 1 if an output differs.

Usage: python -m nunif_tpu_torch.tools.ab_strip ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``)
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import statistics
import sys

H, W, C = 1104, 1920, 96
BLOCKS = ((8, 8), (16, 8), (8, 16), (4, 32), (16, 4), (46, 8), (8, 32))
HBM_BYTES_PER_S = 3.35e12
BOUND_MS = 2 * H * W * C * 2 / HBM_BYTES_PER_S * 1e3


def key(name: str, rh: int, cw: int) -> str:
    return f"{name} rh={rh} cw={cw}"


def sha1(t) -> str:
    import torch
    return hashlib.sha1(t.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()


def at_scale_2(torch, probes, fn, x, rh, cw):
    """fn's output at scale 2.0: through its ``scale`` keyword or, in a
    tree whose wrappers take none, through the scale they look up."""
    if "scale" in inspect.signature(fn).parameters:
        return fn(x, rh, cw, scale=2.0)
    saved = probes._scale_of
    probes._scale_of = lambda t: torch.tensor(2.0, dtype=t.dtype).to(t.device)
    try:
        return fn(x, rh, cw)
    finally:
        probes._scale_of = saved


def time_rounds(torch, fn, iters: int = 30, rounds: int = 5) -> list:
    """ms a call in each round: CUDA events around ``iters`` calls after a
    warm call.  Kept here, not taken from the tree under test, so that both
    trees are timed by the same code."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def child(root: str) -> dict:
    """Time both T1 kernels of the tree at ``root`` at every block; {key:
    {"ms", "min_ms", "sha1", "sha1_x2"}}."""
    sys.path.insert(0, root)
    import torch
    from nunif_tpu_torch.ops import probes
    assert probes.__file__ == os.path.join(root, "nunif_tpu_torch", "ops",
                                           "probes.py"), probes.__file__
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, H, W, C), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for rh, cw in BLOCKS:
        if (H // 6) % rh or (W // 6) % cw:  # skipped by the tool, as by the TPU's
            continue
        for fn in (probes.strip_pass, probes.strip_relayout):
            y = fn(x, rh, cw)
            y2 = at_scale_2(torch, probes, fn, x, rh, cw)
            torch.cuda.synchronize()
            rounds = time_rounds(torch, lambda: fn(x, rh, cw))
            out[key(fn.__name__, rh, cw)] = dict(
                ms=statistics.median(rounds), min_ms=min(rounds),
                sha1=sha1(y), sha1_x2=sha1(y2))
            del y, y2
    return out


def main(root_a: str, root_b: str) -> int:
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    runs = run_turns(__file__, root_a, root_b,
                     {key("strip_relayout", 8, 8): 1})
    keys = list(runs[0][1])
    for k in keys:
        med = {lab: statistics.median(s[k]["ms"] for l2, s, _f in runs if l2 == lab)
               for lab in ("A", "B")}
        least = {lab: min(s[k]["min_ms"] for l2, s, _f in runs if l2 == lab)
                 for lab in ("A", "B")}
        print(f"{k}: A {med['A']:.4f} (min {least['A']:.4f}) B {med['B']:.4f} "
              f"(min {least['B']:.4f}) ms, bound {BOUND_MS:.4f} ms (A "
              f"{100 * BOUND_MS / med['A']:.1f}%, B {100 * BOUND_MS / med['B']:.1f}%)")
    ok = True
    for k in keys:
        for field in ("sha1", "sha1_x2"):
            same = len({s[k][field] for _l, s, _f in runs}) == 1
            ok &= same
            if not same:
                print(f"{k} ({field}): outputs DIFFER between the trees")
    print(f"T1 outputs at all {len(keys)} kernel-blocks, at scales 1 and 2: "
          f"identical in every run of both trees: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
