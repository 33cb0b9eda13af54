"""The end-to-end frames of two source trees on one card, in turns: the
swin_unet_2x 1080p -> 4K frame (one 1120x1936 tile, K1 path), the
swin_unet_4xl 540p -> 4K frame (one 592x976 tile) and the iw3 batch of 8
1080p frames to half-SBS, as ``chip_smoke.py`` builds them (seeded tamed /
shaped weights through ``.nztm``, each tree's own ``chip_smoke`` helpers).

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A (``ab_swin_block.run_turns``); a
frame's time is the median of 5 after a warm one, host clock around a
synchronised call.  Prints each run, the medians by tree, and fails unless
every run of both trees gives the same output bytes (sha1) for each frame.

Usage: python -m nunif_tpu_torch.tools.ab_frames ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/`` and
``chip_smoke.py``)
"""
from __future__ import annotations

import os
import sys

FRAMES = {"swin_unet_2x 1080p": 1, "swin_unet_4xl 540p": 1,
          "iw3 8x1080p": 1}


def child(root: str) -> dict:
    """Time the three frames of the tree at ``root``: {name: {"ms", "min",
    "runs"}} and {"digests": {name: sha1}}."""
    sys.path.insert(0, root)
    import hashlib
    import statistics
    import tempfile
    import time
    import numpy as np
    import torch
    import chip_smoke as cs
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    from nunif_tpu_torch.models import from_flax
    from nunif_tpu_torch.utils.tiling import TiledRenderer
    from nunif_tpu_torch.waifu2x.models.swin_unet import (
        SwinUNet2x, swin_unet_4xl, tamed_flax_params)
    assert cs.__file__.startswith(root), cs.__file__
    dev = torch.device("cuda")

    def waifu2x(model, hw, tile, seed):
        from_flax(model, tamed_flax_params(model, seed=0))
        model = model.to(dev).eval().requires_grad_(False)
        frame = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, hw + (3,), dtype=np.uint8)).to(dev)
        program = TiledRenderer(model).frame_program(*hw, tile_size=tile)
        return lambda: program(frame)

    with tempfile.TemporaryDirectory() as d:
        dm, flow = cs.iw3_models(torch, dev, d)
    cfg = StereoConfig(method="row_flow_v3", divergence=2.0, convergence=0.5,
                       format=StereoFormat(half_sbs=True))
    proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)
    frames = cs.iw3_frames(torch, dev, cs.IW3_BATCH, *cs.IW3_HW, seed=4)
    runs = {"swin_unet_2x 1080p": waifu2x(SwinUNet2x(), (1080, 1920),
                                          (1120, 1936), 1),
            "swin_unet_4xl 540p": waifu2x(swin_unet_4xl(), (540, 960),
                                          (592, 976), 6),
            "iw3 8x1080p": lambda: proc(frames)}
    out, digests = {}, {}
    for name, fn in runs.items():
        y = fn()
        torch.cuda.synchronize()
        digests[name] = hashlib.sha1(
            y.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(ms=statistics.median(times), min=min(times),
                         runs=times)
        del y
        torch.cuda.empty_cache()
    out["digests"] = digests
    return out


def main(root_a: str, root_b: str) -> int:
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    runs = run_turns(__file__, root_a, root_b, FRAMES)
    for name in FRAMES:
        for label in ("A", "B"):
            ms = [s[name]["ms"] for lab, s, _f in runs if lab == label]
            least = min(s[name]["min"] for lab, s, _f in runs if lab == label)
            print(f"{name} {label}: medians {[round(v, 3) for v in ms]}, "
                  f"least run {least:.3f} ms")
    same = all(s["digests"] == runs[0][1]["digests"] for _l, s, _f in runs)
    print(f"digests {runs[0][1]['digests']}; identical in every run of "
          f"both trees: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        import json
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
