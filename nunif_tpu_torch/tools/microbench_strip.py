"""T1 on the card: the cost of an image strip <-> window relayout inside a
kernel (the question of ``tools/microbench_strip.py``).

Times, on a bf16 (1, 1104, 1920, 96) image, the pass kernel and the
relayout round-trip kernel (``ops/probes.py``) for the tool's (rh, cw)
window blocks, beside the plain twin (x * scale) and the round trip through
device memory (window partition, scale, window reverse).

Usage: python -m nunif_tpu_torch.tools.microbench_strip
"""
from __future__ import annotations

from . import require_cuda, time_ms

H, W, C, WS = 1104, 1920, 96, 6
BLOCKS = ((8, 8), (16, 8), (8, 16), (4, 32), (16, 4), (46, 8), (8, 32))


def run(iters: int = 30) -> dict:
    import torch
    from ..ops import probes
    print(f"device: {require_cuda()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, H, W, C), generator=gen, device="cuda").to(torch.bfloat16)
    nh, nw = H // WS, W // WS
    lib = time_ms(lambda: probes.strip_partition_roundtrip(x, WS), iters)
    print(f"PyTorch partition+reverse roundtrip: {lib:.3f} ms", flush=True)
    plain = time_ms(lambda: probes.strip_plain(x), iters)
    print(f"plain twin (x * scale): {plain:.3f} ms", flush=True)
    rows = []
    for rh, cw in BLOCKS:
        if nh % rh or nw % cw:
            continue
        tp = time_ms(lambda: probes.strip_pass(x, rh, cw, window=WS), iters)
        tr = time_ms(lambda: probes.strip_relayout(x, rh, cw, window=WS),
                     iters)
        print(f"strip rh={rh:2d} cw={cw:2d}: pass={tp:.3f} ms  "
              f"relayout-roundtrip={tr:.3f} ms  (delta {tr - tp:+.3f})",
              flush=True)
        rows.append(dict(rh=rh, cw=cw, pass_ms=tp, relayout_ms=tr))
    return dict(rows=rows, plain_ms=plain, library_ms=lib,
                nbytes=2 * x.numel() * x.element_size())


if __name__ == "__main__":
    run()
