"""K1 of two source trees on one card, in turns: the image-layout Swin block
(``ops/swin_attention.py:fused_swin_block_image``) at the seven bf16 shapes
of the swin_unet_2x 1080p frame, with seeded weights.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints ms a shape and the frame sum
(launches a frame times ms) for each run, the medians by tree, and whether
the two trees' outputs are bit-identical.

Usage: python -m nunif_tpu_torch.tools.ab_swin_block ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``)
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

# (C, H, W, shift, skip) and launches a frame, as chip_smoke.py counts them
SHAPES = {(96, 1104, 1920, 0, False): 1, (96, 1104, 1920, 3, False): 2,
          (96, 1104, 1920, 0, True): 1, (192, 552, 960, 0, False): 2,
          (192, 552, 960, 3, False): 2, (192, 276, 480, 0, False): 3,
          (192, 276, 480, 3, False): 3}


def child(root: str) -> dict:
    """Time K1 of the tree at ``root`` at every shape; ms and an output
    digest a shape."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from nunif_tpu_torch.modules.attention import expand_relative_bias
    from nunif_tpu_torch.ops import swin_attention as k1
    from nunif_tpu_torch.tools import time_ms
    assert k1.__file__.startswith(root), k1.__file__
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    out = {}
    for c, h, w, shift, with_skip in SHAPES:
        hid = 2 * c
        weights = [t(rng.standard_normal((c, 3 * c)) / np.sqrt(c)),
                   t(rng.normal(0, 0.02, (3 * c,))),
                   t(rng.standard_normal((c, c)) / np.sqrt(c)),
                   t(rng.normal(0, 0.02, (c,))),
                   t(rng.standard_normal((c, hid)) / np.sqrt(c)),
                   t(rng.normal(0, 0.02, (hid,))),
                   t(rng.standard_normal((hid, c)) / np.sqrt(hid)),
                   t(rng.normal(0, 0.02, (c,))),
                   expand_relative_bias(t(rng.standard_normal((121, 6))), 6)]
        x = t(rng.normal(0, 0.5, (1, h, w, c)), torch.bfloat16)
        skip = t(rng.normal(0, 0.5, (1, h, w, c)), torch.bfloat16) \
            if with_skip else None
        kw = dict(num_heads=6, window=6, shift=shift, skip=skip)
        y = k1.fused_swin_block_image(x, *weights, **kw)
        digest = hashlib.sha1(y.view(torch.int16).cpu().numpy().tobytes())
        ms = time_ms(lambda: k1.fused_swin_block_image(x, *weights, **kw), 5)
        out[str((c, h, w, shift, with_skip))] = dict(ms=ms,
                                                     sha1=digest.hexdigest())
        del x, skip, y
        torch.cuda.empty_cache()
    return out


def run_turns(script: str, root_a: str, root_b: str, launches: dict,
              child_args=lambda label, turn: []):
    """Run ``script --child ROOT [args]`` for the trees in the order A B B
    A, each in a process of its own started in its tree.  A child prints a
    JSON object {str(shape): {"ms": ...}} as its last line.  Prints ms a
    shape and the frame sum (``launches[shape]`` times ms) for each run
    and the medians by tree; returns [(label, shapes, frame sum)], or
    exits with a failing child's code."""
    runs = []
    for turn, (label, root) in enumerate((("A", root_a), ("B", root_b),
                                          ("B", root_b), ("A", root_a))):
        res = subprocess.run([sys.executable, script, "--child", root,
                              *child_args(label, turn)],
                             cwd=root, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            sys.exit(res.returncode)
        shapes = json.loads(res.stdout.strip().splitlines()[-1])
        frame = sum(shapes[str(k)]["ms"] * n for k, n in launches.items())
        runs.append((label, shapes, frame))
        print(f"{label} ({root}): frame sum {frame:.3f} ms; "
              + ", ".join(f"{k} {v['ms']:.3f}" for k, v in shapes.items()),
              flush=True)
    for label in ("A", "B"):
        frames = [f for lab, _s, f in runs if lab == label]
        print(f"{label}: frame sums {[round(f, 3) for f in frames]}, median "
              f"{statistics.median(frames):.3f} ms")
    return runs


def main(root_a: str, root_b: str) -> int:
    runs = run_turns(__file__, root_a, root_b, SHAPES)
    same = all(runs[0][1][k]["sha1"] == runs[1][1][k]["sha1"]
               for k in runs[0][1])
    print(f"outputs bit-identical between A and B: {same}")
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
