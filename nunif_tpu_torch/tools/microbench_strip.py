"""T1 on the card: the cost of an image strip <-> window relayout inside a
kernel (the question of ``tools/microbench_strip.py``).

Times, on a bf16 (1, 1104, 1920, 96) image, the pass kernel and the
relayout round-trip kernel (``ops/probes.py``) for the tool's (rh, cw)
window blocks, beside the plain twin (x * scale) and the round trip through
device memory (window partition, scale, window reverse).  Each time is the
median of ``rounds`` rounds of CUDA events around ``iters`` calls; the
least round is printed beside it.  With ``--device-ms`` it prints instead,
as one JSON line, both kernels' device time a launch at each block
(``tools.device_ms``, torch.profiler).

Usage: python -m nunif_tpu_torch.tools.microbench_strip [--device-ms]
"""
from __future__ import annotations

import json
import statistics
import sys

from . import device_ms, require_cuda, time_ms, time_rounds

H, W, C, WS = 1104, 1920, 96, 6
BLOCKS = ((8, 8), (16, 8), (8, 16), (4, 32), (16, 4), (46, 8), (8, 32))


def image():
    """The tool's input: a seeded bf16 (1, H, W, C) image on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch.randn((1, H, W, C), generator=gen, device="cuda").to(torch.bfloat16)


def blocks():
    """The tool's blocks that tile the image (the TPU tool skips the rest)."""
    return [(rh, cw) for rh, cw in BLOCKS if (H // WS) % rh == 0 and (W // WS) % cw == 0]


def device_times() -> dict:
    """{"rh cw": {"pass_device_ms", "relayout_device_ms"}} at each block."""
    from ..ops import probes
    require_cuda()
    x = image()
    return {f"{rh} {cw}": dict(
        pass_device_ms=device_ms(lambda: probes.strip_pass(x, rh, cw, window=WS)),
        relayout_device_ms=device_ms(
            lambda: probes.strip_relayout(x, rh, cw, window=WS)))
        for rh, cw in blocks()}


def run(iters: int = 30, rounds: int = 5) -> dict:
    from ..ops import probes
    print(f"device: {require_cuda()}", flush=True)
    x = image()
    lib = time_ms(lambda: probes.strip_partition_roundtrip(x, WS), iters)
    print(f"PyTorch partition+reverse roundtrip: {lib:.3f} ms", flush=True)
    plain = time_ms(lambda: probes.strip_plain(x), iters)
    print(f"plain twin (x * scale): {plain:.3f} ms", flush=True)
    rows = []
    for rh, cw in blocks():
        tp = time_rounds(lambda: probes.strip_pass(x, rh, cw, window=WS),
                         iters, rounds)
        tr = time_rounds(lambda: probes.strip_relayout(x, rh, cw, window=WS),
                         iters, rounds)
        row = dict(rh=rh, cw=cw, pass_ms=statistics.median(tp),
                   pass_min_ms=min(tp), relayout_ms=statistics.median(tr),
                   relayout_min_ms=min(tr))
        print(f"strip rh={rh:2d} cw={cw:2d}: pass={row['pass_ms']:.4f} ms "
              f"(min {row['pass_min_ms']:.4f})  relayout-roundtrip="
              f"{row['relayout_ms']:.4f} ms (min {row['relayout_min_ms']:.4f})"
              f"  (delta {row['relayout_ms'] - row['pass_ms']:+.4f})",
              flush=True)
        rows.append(row)
    return dict(rows=rows, plain_ms=plain, library_ms=lib,
                nbytes=2 * x.numel() * x.element_size())


if __name__ == "__main__":
    if sys.argv[1:] == ["--device-ms"]:
        print(json.dumps(device_times()))
    else:
        run()
