"""The exported swin_unet_2x program of two source trees on one card, in
turns: ``models/export.py:export_model`` at tile 256, batch 4, bf16 (as
``chip_smoke.py``'s "export" phase), unbaked and baked, against the eager
model on the same input (seeded tamed weights).

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A (``ab_swin_block.run_turns``).  A
child times the eager model and both programs (``tools.time_ms``, host
clock around a synchronised call), and profiles one call of each
(``torch.profiler``): its device kernels, their device time and the
kernels by name.  Prints each run, the medians by tree, and fails unless
each program's output equals the eager model's in every run.

Usage: python -m nunif_tpu_torch.tools.ab_export ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``)
"""
from __future__ import annotations

import collections
import os
import statistics
import sys

SHAPE = (4, 256, 256, 3)


def child(root: str) -> dict:
    """{"eager" / "program" / "program_baked": {"ms", "kernels",
    "device_ms", "by_name", "equal"}} for the tree at ``root``."""
    sys.path.insert(0, root)
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nunif_tpu_torch.models import create_model, export, from_flax
    from nunif_tpu_torch.tools import time_ms
    from nunif_tpu_torch.waifu2x.models.swin_unet import tamed_flax_params
    assert export.__file__.startswith(root), export.__file__
    dev = torch.device("cuda")
    model = create_model("waifu2x.swin_unet_2x")
    from_flax(model, tamed_flax_params(model, seed=0))
    model = model.to(dev).eval().requires_grad_(False)
    x = torch.rand(SHAPE, generator=torch.Generator(device=dev).manual_seed(12),
                   device=dev)
    with torch.no_grad():
        want = model(x.to(torch.bfloat16)).float()
    calls = {"eager": lambda: model(x.to(torch.bfloat16)).float()}
    with tempfile.TemporaryDirectory() as d:
        for key, bake in (("program", False), ("program_baked", True)):
            path = os.path.join(d, f"{key}.pt2")
            export.export_model(model, path, SHAPE, bake_params=bake)
            program = export.ExportedModel(path)
            calls[key] = lambda program=program: program(x)
    out = {}
    for key, fn in calls.items():
        with torch.no_grad():
            got = fn()
            torch.cuda.synchronize()
            ms = time_ms(fn, 10)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        by_name = collections.Counter(e.name[:60] for e in kernels)
        out[key] = dict(
            ms=ms, kernels=len(kernels),
            device_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            by_name=dict(by_name.most_common(8)),
            equal=bool(torch.equal(got, want)))
    return out


def main(root_a: str, root_b: str) -> int:
    from nunif_tpu_torch.tools.ab_swin_block import run_turns
    runs = run_turns(__file__, root_a, root_b, {"program": 1})
    for label in ("A", "B"):
        mine = [s for lab, s, _f in runs if lab == label]
        for key in ("eager", "program", "program_baked"):
            ms = [s[key]["ms"] for s in mine]
            print(f"{label} {key}: median {statistics.median(ms):.3f} ms "
                  f"{[round(v, 3) for v in ms]}; a call {mine[0][key]['kernels']} "
                  f"device kernels, {mine[0][key]['device_ms']:.3f} device ms; "
                  f"by name {mine[0][key]['by_name']}")
    ok = all(s[k]["equal"] for _l, s, _f in runs
             for k in ("program", "program_baked"))
    print(f"each program's output equal to the eager model's in every run: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        import json
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
