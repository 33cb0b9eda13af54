"""K7 of two source trees on one card, in turns, and the iw3 batch around it.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A, as ``ab_swin_block`` does for K1.  A
run times:
- K7 (``ops/sdpa.py:sdpa``) at the iw3 path's shape and layout, (8, 6,
  1373, 64) bf16 as views of one seeded (8, 1373, 3, 6, 64) qkv tensor, as
  ``dinov2.Attention`` passes them: 20 launches back to back between two
  CUDA events, median of 3;
- the iw3 batch: 8 seeded uint8 1080p frames to half-SBS through
  ``Iw3FrameProcessor``, with the seeded models and frames of the tree's
  own ``chip_smoke.py`` (``iw3_models``, ``iw3_frames``): host clock around
  a synchronised batch, median of 5 after a warm one.
Prints ms by tree and run (the "frame sum" is K7's 12 launches a batch),
the medians, whether K7 of B was faster than K7 of A in every turn, and
the largest difference between the two trees' K7 outputs, which must lie
within K7's absolute tolerance (1e-2; the trees need not be bit-identical).

Usage (card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/`` and
``chip_smoke.py``; the first run of each tree saves its K7 output under
ROOT_B's ``build/ab_flash/``):
    python -m nunif_tpu_torch.tools.ab_flash ROOT_A ROOT_B
"""
from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

SHAPE = (8, 1373, 3, 6, 64)
LAUNCHES = {"k7": 12, "iw3_batch": 0}  # K7 launches in one iw3 batch
K7_ATOL = 1e-2


def qkv_views(torch):
    """Seeded (B, H, N, d) views q, k, v of one (B, N, 3, H, d) tensor."""
    import numpy as np
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        SHAPE, dtype=np.float32)).to("cuda", torch.bfloat16)
    return [qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3)]


def iw3_batch_ms(torch, root: str) -> float:
    """Median ms of 5 iw3 batches after a warm one, with the tree's own
    chip_smoke.py models and frames."""
    import chip_smoke
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    assert chip_smoke.__file__.startswith(root), chip_smoke.__file__
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as model_dir:
        dm, flow = chip_smoke.iw3_models(torch, dev, model_dir)
    cfg = StereoConfig(method="row_flow_v3", divergence=2.0, convergence=0.5,
                       format=StereoFormat(half_sbs=True))
    proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)
    frames = chip_smoke.iw3_frames(torch, dev, chip_smoke.IW3_BATCH,
                                   *chip_smoke.IW3_HW, seed=4)
    proc(frames)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        proc(frames)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def child(root: str, save: str | None) -> dict:
    """K7 back to back and the iw3 batch of the tree at ``root``; K7's
    output saved to ``save`` when given."""
    sys.path.insert(0, root)
    import torch
    from nunif_tpu_torch.ops import sdpa as k7
    from nunif_tpu_torch.tools import time_ms
    assert k7.__file__.startswith(root), k7.__file__
    q, k, v = qkv_views(torch)
    y = k7.sdpa(q, k, v)
    out = {"k7": dict(ms=time_ms(lambda: k7.sdpa(q, k, v), 20))}
    if save:
        torch.save(y.cpu(), save)
    del q, k, v, y
    torch.cuda.empty_cache()
    out["iw3_batch"] = dict(ms=iw3_batch_ms(torch, root))
    return out


def main(root_a: str, root_b: str) -> int:
    import torch
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    save_dir = os.path.join(root_b, "build", "ab_flash")
    os.makedirs(save_dir, exist_ok=True)
    saved = {"A": os.path.join(save_dir, "a.pt"),
             "B": os.path.join(save_dir, "b.pt")}
    runs = run_turns(__file__, root_a, root_b, LAUNCHES,
                     lambda label, turn: [saved[label]] if turn < 2 else [])
    for key in LAUNCHES:
        for label in ("A", "B"):
            ms = [shapes[key]["ms"] for lab, shapes, _f in runs if lab == label]
            print(f"{key} {label}: {[round(t, 4) for t in ms]} ms, median "
                  f"{statistics.median(ms):.4f} ms")
    k7_a = [shapes["k7"]["ms"] for lab, shapes, _f in runs if lab == "A"]
    k7_b = [shapes["k7"]["ms"] for lab, shapes, _f in runs if lab == "B"]
    print(f"K7 of B faster than K7 of A in every turn: {max(k7_b) < min(k7_a)}")
    d = (torch.load(saved["A"]).float() - torch.load(saved["B"]).float()).abs()
    within = float(d.max()) <= K7_ATOL
    print(f"K7 outputs: max abs difference A vs B {float(d.max()):.6g}, "
          f"bit-equal {float((d == 0).float().mean()):.4f}, within K7's "
          f"absolute tolerance {K7_ATOL}: {within}")
    return 0 if within else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        import json
        print(json.dumps(child(sys.argv[2],
                               sys.argv[3] if len(sys.argv) > 3 else None)))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
