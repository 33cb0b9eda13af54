"""K2 of two source trees on one card, in turns: the stem conv
(``ops/conv3x3.py:stem_conv3x3``) in bf16 at its two main-path shapes,
swin_unet_2x's 1080p patch_conv1 (48 -> 96) and swin_unet_4xl's 540p one
(96 -> 192), with seeded inputs.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A, as ``ab_swin_block`` does for K1.  A
tree whose wrapper takes a pre-packed weight gets one packed before the
timing, as the model's stem module passes it.  Prints ms a shape and the
frame sum (one launch a frame: the 2x and the 4xl frame each run one) for
each run, the medians by tree, and the largest difference between the two
trees' outputs, which must lie within K2's bf16 tolerance (1/64 relative +
1e-2 absolute; the trees sum in different orders, so they need not be
bit-identical).

Usage: python -m nunif_tpu_torch.tools.ab_stem_conv ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``; outputs of
the first run of each tree are kept under ROOT_B's ``build/ab_stem_conv/``)
"""
from __future__ import annotations

import os
import sys

# ((B, H, W), Cin, Cout) and launches a frame
SHAPES = {((1, 1118, 1934), 48, 96): 1, ((1, 590, 974), 96, 192): 1}
TOL = (1 / 64, 1e-2)


def child(root: str, save: str | None) -> dict:
    """Time K2 of the tree at ``root`` at every shape; ms a shape, and the
    outputs saved to ``save`` when given."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from nunif_tpu_torch.ops import conv3x3 as k2
    from nunif_tpu_torch.tools import time_ms
    assert k2.__file__.startswith(root), k2.__file__
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    out, outputs = {}, {}
    for (b, h, w), cin, cout in SHAPES:
        x = t(rng.normal(0, 0.5, (b, h, w, cin)), torch.bfloat16)
        kern = t(rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)))
        bias = t(rng.normal(0, 0.1, (cout,)))
        kw = dict(crop=6, lrelu_slope=0.1)
        if hasattr(k2, "pack_stem_weights"):
            kw["packed"] = (k2.pack_stem_weights(kern, torch.bfloat16),
                            bias.float().contiguous())
        y = k2.stem_conv3x3(x, kern, bias, **kw)
        ms = time_ms(lambda: k2.stem_conv3x3(x, kern, bias, **kw), 20)
        key = str(((b, h, w), cin, cout))
        out[key] = dict(ms=ms)
        outputs[key] = y.cpu()
        del x, y
        torch.cuda.empty_cache()
    if save:
        torch.save(outputs, save)
    return out


def main(root_a: str, root_b: str) -> int:
    import torch
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    save_dir = os.path.join(root_b, "build", "ab_stem_conv")
    os.makedirs(save_dir, exist_ok=True)
    saved = {"A": os.path.join(save_dir, "a.pt"),
             "B": os.path.join(save_dir, "b.pt")}
    run_turns(__file__, root_a, root_b, SHAPES,
              lambda label, turn: [saved[label]] if turn < 2 else [])
    a, b = torch.load(saved["A"]), torch.load(saved["B"])
    ok = True
    for key in a:
        d = (a[key].float() - b[key].float()).abs()
        within = bool((d <= b[key].float().abs() * TOL[0] + TOL[1]).all())
        ok &= within
        print(f"{key}: max abs difference A vs B {float(d.max()):.6g}, "
              f"bit-equal {float((d == 0).float().mean()):.4f}, within "
              f"K2's tolerance: {within}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        import json
        print(json.dumps(child(sys.argv[2],
                               sys.argv[3] if len(sys.argv) > 3 else None)))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
