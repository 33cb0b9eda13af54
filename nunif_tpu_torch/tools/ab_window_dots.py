"""T3 of two source trees on one card, in turns: the streamed window dot pair
(``ops/probes.py:window_dots``), bf16 and int8, at the shapes of
``tools/microbench_int8_attn.py`` (14720 windows, N 36, C 96, P 216, vhat
104 wide) and at N 37, P 200, vhat 112 wide (4096 windows), from seeded
inputs made on the card.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints ms a shape for each run
(CUDA events, median of 3 runs of 8 calls), the medians by tree with the
share of the shape's least time (the operands read once, the bf16 output
written once, at 3.35 TB/s), and whether every output (a sha1 of its bytes)
is the same in every run of both trees.  Exits 1 if an output differs.

Usage: python -m nunif_tpu_torch.tools.ab_window_dots ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``)
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import sys

# (windows, N, C, P, Cv); the first is the tool's
SHAPES = [(14720, 36, 96, 216, 104), (4096, 37, 96, 200, 112)]
HBM_BYTES_PER_S = 3.35e12


def key(shape, dtype: str) -> str:
    return f"{shape} {dtype}"


def bound_ms(shape, elem_bytes: int) -> float:
    nw, n, c, p, cv = shape
    return nw * ((n * c + c * p + p * cv) * elem_bytes + n * c * 2) \
        / HBM_BYTES_PER_S * 1e3


def inputs(torch, shape, dtype, gen):
    """q, khat, vhat: uniform [-1, 1) in bf16, or int8 in [-127, 127)."""
    nw, n, c, p, cv = shape
    shapes = ((nw, n, c), (nw, c, p), (nw, p, cv))
    if dtype == torch.int8:
        return [torch.randint(-127, 127, s, generator=gen, device="cuda",
                              dtype=torch.int8) for s in shapes]
    return [(torch.rand(s, generator=gen, device="cuda") * 2 - 1).to(dtype)
            for s in shapes]


def child(root: str) -> dict:
    """Time T3 of the tree at ``root`` at every shape and dtype; {key: {"ms",
    "sha1", "bound_ms"}}."""
    sys.path.insert(0, root)
    import torch
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.tools import time_ms
    assert probes.__file__ == os.path.join(root, "nunif_tpu_torch", "ops",
                                           "probes.py"), probes.__file__
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in SHAPES:
        for dtype in (torch.bfloat16, torch.int8):
            ins = inputs(torch, shape, dtype, gen)
            y = probes.window_dots(*ins)
            torch.cuda.synchronize()
            out[key(shape, str(dtype).split(".")[1])] = dict(
                ms=time_ms(lambda: probes.window_dots(*ins), 8),
                sha1=hashlib.sha1(y.contiguous().view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest(),
                bound_ms=bound_ms(shape, ins[0].element_size()))
            del ins, y
            torch.cuda.empty_cache()
    return out


def main(root_a: str, root_b: str) -> int:
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    runs = run_turns(__file__, root_a, root_b, {key(SHAPES[0], "bfloat16"): 1})
    keys = list(runs[0][1])
    for k in keys:
        b = runs[0][1][k]["bound_ms"]
        med = {lab: statistics.median(s[k]["ms"] for l2, s, _f in runs if l2 == lab)
               for lab in ("A", "B")}
        print(f"{k}: A {med['A']:.4f} B {med['B']:.4f} ms, bound {b:.4f} ms "
              f"(A {100 * b / med['A']:.1f}%, B {100 * b / med['B']:.1f}%)")
    ok = True
    for k in keys:
        same = len({s[k]["sha1"] for _l, s, _f in runs}) == 1
        ok &= same
        if not same:
            print(f"{k}: outputs DIFFER between the trees")
    print(f"T3 outputs at all {len(keys)} shapes and dtypes: identical in every "
          f"run of both trees: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
