"""Where a tile of K1's bf16 kernel spends its time, on the card.

Copies ``nunif_tpu_torch/`` to ``build/swin_block_phases/`` and adds
``clock64()`` counters to the copy's ``csrc/swin_block.cu``: thread 0 of
each block adds the cycles between the consumers' named barriers of the
tile loop to a ``__device__`` array (one phase each: token table, gather,
qkv, attention, proj, fc1, fc2 with the tile's last barrier), and the
consumer's and the producer's waits on the weight ring; an added C entry
point reads the array back.  The copy builds into its own ``build/`` and
runs K1 at three shapes of the swin_unet_2x 1080p frame with seeded
weights.  Prints ms a launch (CUDA events, 5 launches, median of 3) and
cycles a tile by phase, averaged over the tiles.  The counters add a few
atomics a tile: compare phases with each other, and take kernel times
from ``chip_smoke.py``.

Usage: python -m nunif_tpu_torch.tools.swin_block_phases   (card only)
"""
from __future__ import annotations

import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "swin_block_phases"
PHASES = ("token table", "gather", "qkv", "attention", "proj", "fc1",
          "fc2 + end")
RING_WAIT, PRODUCER_WAIT, TILES = 10, 11, 12
# (C, H, W, shift) of K1 on the 2x frame
SHAPES = ((96, 1104, 1920, 0), (96, 1104, 1920, 3), (192, 552, 960, 0))


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"swin_block.cu has changed; not found: {old!r}")
    return src.replace(old, new, 1)


def instrument(src: str) -> str:
    """swin_block.cu with the counters added."""
    src = _sub(src, '#include "window_attention.cuh"\n',
               '#include "window_attention.cuh"\n'
               "__device__ unsigned long long g_phase[16];\n")
    src = _sub(src, "    mbar_wait(&ring.full[s], (chunk / ring.stages) & 1);\n",
               "    const long long w0 = clock64();\n"
               "    mbar_wait(&ring.full[s], (chunk / ring.stages) & 1);\n"
               "    if (threadIdx.x == 0) atomicAdd(&g_phase[%d], "
               "(unsigned long long)(clock64() - w0));\n" % RING_WAIT)
    src = _sub(src, "              mbar_wait(&empty[s], ((chunk / p.stages) & 1) ^ 1);",
               "              const long long w0 = clock64();\n"
               "              mbar_wait(&empty[s], ((chunk / p.stages) & 1) ^ 1);\n"
               "              atomicAdd(&g_phase[%d], (unsigned long long)"
               "(clock64() - w0));" % PRODUCER_WAIT)
    loop = ("  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {\n"
            "    const int win0")
    head, body = src.split(loop, 1)
    count = [0]

    def stamp(m):
        i = count[0]
        count[0] += 1
        return (m.group(0) + "\n    if (threadIdx.x == 0) { const long long now = "
                f"clock64(); atomicAdd(&g_phase[{i}], (unsigned long long)"
                "(now - t_last)); t_last = now; }")
    body = re.sub(r"named_bar_sync\(kPhaseBar, kConsumers\);", stamp, body)
    if count[0] != len(PHASES):
        raise RuntimeError(f"swin_block.cu has {count[0]} phase barriers, "
                           f"not {len(PHASES)}")
    src = (head + "  long long t_last = clock64();\n" + loop.replace(
        "{\n", "{\n    if (threadIdx.x == 0) atomicAdd(&g_phase[%d], 1ull);\n" % TILES)
        + body)
    return src + """
extern "C" int nunif_swin_phase(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
"""


def child() -> None:
    """In the copy: time K1 at SHAPES and print cycles a tile by phase."""
    import ctypes
    sys.path.insert(0, str(COPY))
    import numpy as np
    import torch
    from nunif_tpu_torch.ops import _build
    from nunif_tpu_torch.ops import swin_attention as k1
    from nunif_tpu_torch.tools import require_cuda, time_ms
    from nunif_tpu_torch.tools.ab_swin_block import block_weights
    assert k1.__file__.startswith(str(COPY)), k1.__file__
    print(f"devices: {require_cuda()}", flush=True)
    read = _build.library().nunif_swin_phase
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 16)()
    rng = np.random.default_rng(0)
    for c, h, w, shift in SHAPES:
        weights = block_weights(torch, rng, c)
        x = torch.from_numpy(rng.normal(0, 0.5, (1, h, w, c)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        kw = dict(num_heads=6, window=6, shift=shift,
                  packed=k1.pack_weights(*weights, torch.bfloat16))
        ms = time_ms(lambda: k1.fused_swin_block_image(x, *weights, **kw), 5)
        torch.cuda.synchronize()
        _build.check(read(counts), "nunif_swin_phase")  # reset
        k1.fused_swin_block_image(x, *weights, **kw)
        torch.cuda.synchronize()
        _build.check(read(counts), "nunif_swin_phase")
        tiles = counts[TILES]
        cycles = [counts[i] / tiles for i in range(len(PHASES))]
        print(f"K1 C={c} {h}x{w} shift={shift}: {ms:.3f} ms a launch, {tiles} "
              f"tiles; cycles a tile: " + ", ".join(
                  f"{name} {v:.0f}" for name, v in zip(PHASES, cycles))
              + f"; sum {sum(cycles):.0f}; waits on the ring: consumer "
              f"{counts[RING_WAIT] / tiles:.0f}, producer "
              f"{counts[PRODUCER_WAIT] / tiles:.0f}", flush=True)


def main() -> int:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "nunif_tpu_torch", COPY / "nunif_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "nunif_tpu_torch" / "csrc" / "swin_block.cu"
    cu.write_text(instrument(cu.read_text()))
    return subprocess.run([sys.executable, __file__, "--child"],
                          cwd=COPY).returncode


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        sys.exit(main())
