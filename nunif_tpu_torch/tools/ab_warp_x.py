"""K3 of two source trees on one card, in turns: the bounded horizontal warp
(``modules/grid_sample.py:warp_x_bounded``) at the iw3 path's shape (both
eyes of 8 1080p frames, max_shift 28) and at three others (C = 8; a row of
1001 pixels, whose bytes are not a multiple of 16; C = 8 at W = 7680, too
wide for one ring stage), each with fp32 x (as the path calls it) and bf16
x, from seeded inputs made on the card.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints ms a shape for each run (the
wrapper as a caller calls it, CUDA events, median of 3 runs of 10 calls),
the medians by tree with the share of the shape's least time (x and delta
read once, the output written once, at 3.35 TB/s), and whether every output
(a sha1 of its bytes) is the same in every run of both trees.  Exits 1 if
an output differs.

Usage: python -m nunif_tpu_torch.tools.ab_warp_x ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``)
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import sys

# (B, H, W, C, max_shift); the first is the iw3 path's launch
SHAPES = [(16, 1080, 1920, 3, 28), (2, 90, 1920, 8, 28), (8, 270, 1001, 3, 28),
          (2, 90, 7680, 8, 28)]
HBM_BYTES_PER_S = 3.35e12


def key(shape, dtype: str) -> str:
    return f"{shape} {dtype}"


def bound_ms(shape, elem_bytes: int) -> float:
    b, h, w, c, _ms = shape
    return b * h * w * (2 * c * elem_bytes + 4) / HBM_BYTES_PER_S * 1e3


def child(root: str) -> dict:
    """Time K3 of the tree at ``root`` at every shape and dtype; {key:
    {"ms", "sha1", "bound_ms"}}."""
    sys.path.insert(0, root)
    import torch
    from nunif_tpu_torch.modules import grid_sample as k3
    from nunif_tpu_torch.tools import time_ms
    assert k3.__file__ == os.path.join(root, "nunif_tpu_torch", "modules",
                                       "grid_sample.py"), k3.__file__
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in SHAPES:
        b, h, w, c, max_shift = shape
        x = torch.rand((b, h, w, c), generator=gen, device="cuda")
        delta = (torch.rand((b, h, w), generator=gen, device="cuda") * 2 - 1) \
            * max_shift
        for dtype in (torch.float32, torch.bfloat16):
            xi = x.to(dtype)
            y = k3.warp_x_bounded(xi, delta, max_shift)
            torch.cuda.synchronize()
            out[key(shape, str(dtype).split(".")[1])] = dict(
                ms=time_ms(lambda: k3.warp_x_bounded(xi, delta, max_shift), 10),
                sha1=hashlib.sha1(y.contiguous().view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest(),
                bound_ms=bound_ms(shape, xi.element_size()))
            del xi, y
        del x, delta
        torch.cuda.empty_cache()
    return out


def main(root_a: str, root_b: str) -> int:
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    runs = run_turns(__file__, root_a, root_b, {key(SHAPES[0], "float32"): 1})
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
    print(f"K3 outputs at all {len(keys)} shapes and dtypes: identical in every "
          f"run of both trees: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
