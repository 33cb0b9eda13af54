"""What bounds K4's bf16 kernel, on the card: K4 timed in variants of
``csrc/window_attn.cu`` that take out one part of its work.

A one-off measurement, kept as the source of the numbers PERF.md gives
under "What bounds it": it edits the kernel's text by exact substitution,
so it is expected to stop working once ``window_attn.cu`` changes, and
it then fails loudly rather than time something else.  It is no part of
any check; mend it only when those numbers are to be taken again.

Copies ``nunif_tpu_torch/`` twice to ``build/window_attn_variants/`` and
edits the copies' ``csrc/window_attn.cu``: in the first, environment
variables read at each launch drop the attention (the consumers only wait
for each window and arrive: the copies alone), drop the copies (the
producer loads and stores nothing: the attention alone, on the zeroed
ring) or cap the ring's stages; in the second, every instantiation has 12
consumer warps.  Each copy builds into its own ``build/``; each variant
runs in a process of its own and times K4 at the eight shapes of the
swin_unet_4xl 540p frame (seeded inputs, 10 launches back to back, median
of 3).  Prints ms a shape and the frame sum (launches a frame times ms),
the unchanged kernel first and last.  The variants' outputs are not
checked: compare their times, and take the kernel's from ``chip_smoke.py``.

Usage: python -m nunif_tpu_torch.tools.window_attn_variants   (card only)
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "window_attn_variants"
KNOBS, WARPS12 = COPY / "knobs", COPY / "warps12"
# label, copy, environment
VARIANTS = (("kernel", KNOBS, {}),
            ("copies only", KNOBS, {"WA_SKIP": "1"}),
            ("attention only", KNOBS, {"WA_SKIP": "2"}),
            ("at most 2 stages", KNOBS, {"WA_STAGES": "2"}),
            ("at most 3 stages", KNOBS, {"WA_STAGES": "3"}),
            ("12 consumer warps", WARPS12, {}),
            ("kernel", KNOBS, {}))


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"window_attn.cu has changed; not found: {old!r}")
    return src.replace(old, new, 1)


def with_knobs(src: str) -> str:
    """window_attn.cu with WA_SKIP (1: no attention, 2: no copies) and
    WA_STAGES (a cap on the ring's stages) read at each launch."""
    src = _sub(src, "#include <atomic>\n", "#include <atomic>\n#include <cstdlib>\n")
    src = _sub(src, "bias_ld, bias_bytes, bar_off;\n};",
               "bias_ld, bias_bytes, bar_off;\n  int skip;\n};")
    src = _sub(src, "  if (P->stages > kMaxStages) P->stages = kMaxStages;\n",
               "  if (P->stages > kMaxStages) P->stages = kMaxStages;\n"
               "  if (getenv(\"WA_STAGES\") && P->stages > atoi(getenv(\"WA_STAGES\")))\n"
               "    P->stages = atoi(getenv(\"WA_STAGES\"));\n")
    src = _sub(src, "        tma_store_5d(&tm_out,",
               "        if (!(p.skip & 2)) tma_store_5d(&tm_out,")
    src = _sub(src, "        mbar_expect_tx(&full[s], tx);\n        for (int seg",
               "        mbar_expect_tx(&full[s], (p.skip & 2) ? 0u : tx);\n"
               "        if (!(p.skip & 2)) for (int seg")
    src = _sub(src, "    for (int u = first; u < units; u += Warps)",
               "    if (!(p.skip & 1)) for (int u = first; u < units; u += Warps)")
    return _sub(src, "  p.bar_off = P.bar_off;\n",
                "  p.bar_off = P.bar_off;\n"
                "  p.skip = getenv(\"WA_SKIP\") ? atoi(getenv(\"WA_SKIP\")) : 0;\n")


def with_12_warps(src: str) -> str:
    return _sub(src, "return tiles <= 3 ? 19 : 12;", "return tiles <= 3 ? 12 : 12;")


def child() -> None:
    """In a copy: time K4 at the 4xl frame's shapes, print ms and the sum."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from nunif_tpu_torch.modules.attention import expand_relative_bias
    from nunif_tpu_torch.ops import swin_attention as k4
    from nunif_tpu_torch.tools import time_ms
    from nunif_tpu_torch.tools.ab_window_attn import FRAME, HEADS, WS
    assert k4.__file__.startswith(os.getcwd()), k4.__file__
    rng = np.random.default_rng(0)
    ms = {}
    for c, h, w, shift in FRAME:
        nw = (h // WS) * (w // WS)
        qkv = torch.from_numpy(rng.standard_normal(
            (nw, WS * WS, 3 * c), dtype=np.float32)).to("cuda", torch.bfloat16)
        bias = expand_relative_bias(torch.from_numpy(rng.standard_normal(
            (121, HEADS)).astype(np.float32)).to("cuda"), WS)
        ms[(c, h, w, shift)] = time_ms(lambda: k4.fused_window_attention(
            qkv, bias, num_heads=HEADS, window=WS, shift=shift, n_wh=h // WS,
            n_ww=w // WS), 10)
        del qkv
        torch.cuda.empty_cache()
    frame = sum(ms[k] * n for k, n in FRAME.items())
    print(f"frame sum {frame:.3f} ms; " + ", ".join(
        f"C={c} {h}x{w} s{s} {v:.4f}" for (c, h, w, s), v in ms.items()),
        flush=True)


def main() -> int:
    from nunif_tpu_torch.tools import require_cuda
    print(f"devices: {require_cuda()}", flush=True)
    shutil.rmtree(COPY, ignore_errors=True)
    for copy, edit in ((KNOBS, with_knobs), (WARPS12, with_12_warps)):
        shutil.copytree(ROOT / "nunif_tpu_torch", copy / "nunif_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = copy / "nunif_tpu_torch" / "csrc" / "window_attn.cu"
        cu.write_text(edit(cu.read_text()))
    for label, copy, env in VARIANTS:
        print(f"{label}: ", end="", flush=True)
        rc = subprocess.run([sys.executable, __file__, "--child"], cwd=copy,
                            env={**os.environ, **env}).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        sys.exit(main())
