"""Where a tile (one group of windows) of T2's kernel spends its time, on
the card.

Copies ``nunif_tpu_torch/`` to ``build/swin_pieces_phases/`` and adds
``clock64()`` counters to the copy's ``csrc/probe_swin_pieces.cu``: thread
0 of every block adds the cycles of each phase of a tile to a
``__device__`` array (the token table; the gather, with W8A8's
quantization; qkv; the attention cut after the variant's piece, with the
q scaling and int8 scores' quantization; proj; fc1; fc2), each phase
ending at the consumers' barrier after it; an added C entry point reads
the array back.  The copy builds into its own ``build/`` and runs T2 at
``tools/microbench_swin_pieces.py``'s two shapes and the given variants.
Prints ms a call (CUDA events, 5 calls, median of 3) and cycles a tile by
phase, averaged over all tiles.  The counters add one atomic a phase a
tile: compare phases with each other, and take kernel times from
``chip_smoke.py``.  For each shape it also prints the exp2 floor of pieces
3 and 4: heads (G N)^2 exp2 a group, at 16 a clock an SM, on the card's
SMs at its top SM clock (``nvidia-smi --query-gpu=clocks.max.sm``): a
count from shapes, not a measurement.

Usage: python -m nunif_tpu_torch.tools.swin_pieces_phases [variant ...]
(card only; default W P0 P2 P3 P4 P0q P4s)
"""
from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "swin_pieces_phases"
PHASES = ("tokens", "gather", "qkv", "attention", "proj", "fc1", "fc2")
TILES = 15
DEFAULT = ("W", "P0", "P2", "P3", "P4", "P0q", "P4s")


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"probe_swin_pieces.cu has changed; not found once: {old!r}")
    return src.replace(old, new, 1)


def _stamp(i: int) -> str:
    return (f"    if (rec) {{ const long long now = clock64(); atomicAdd(&g_phase[{i}], "
            "(unsigned long long)(now - t_last)); t_last = now; }\n")


def instrument(src: str) -> str:
    """probe_swin_pieces.cu with the counters added."""
    src = _sub(src, '#include "wgmma.cuh"\n',
               '#include "wgmma.cuh"\n__device__ unsigned long long g_phase[16];\n')
    src = _sub(src, "  uint32_t piece = 0, bunit = 0;\n",
               "  uint32_t piece = 0, bunit = 0;\n  const bool rec = ctid == 0;\n"
               "  long long t_last = clock64();\n")
    src = _sub(src, "      tok[r] = ((long long)row * p.W + col) * C;\n    }\n"
               "    named_bar_sync(kPsBar, kPsConsumers);\n",
               "      tok[r] = ((long long)row * p.W + col) * C;\n    }\n"
               "    named_bar_sync(kPsBar, kPsConsumers);\n" + _stamp(0)
               + f"    if (rec) atomicAdd(&g_phase[{TILES}], 1ull);\n")
    for i, mark in enumerate(("    // 3. qkv\n", "    // 4. the attention, cut after",
                              "    // 5. out projection", "    // 6. fc1", "    // 7. fc2"), 1):
        src = _sub(src, mark, _stamp(i) + mark)
    end = "    named_bar_sync(kPsBar, kPsConsumers);  // the token table and both regions are free\n"
    src = _sub(src, end, end + _stamp(6))
    return src + """
extern "C" int nunif_swin_pieces_phase(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
"""


def child(names) -> None:
    """In the copy: time T2 at the tool's shapes and print cycles a tile by
    phase."""
    import ctypes
    sys.path.insert(0, str(COPY))
    import torch
    from nunif_tpu_torch.ops import _build, probes
    from nunif_tpu_torch.tools import microbench_swin_pieces as t2, require_cuda, time_ms
    assert probes.__file__.startswith(str(COPY)), probes.__file__
    print(f"devices: {require_cuda()}", flush=True)
    read = _build.library().nunif_swin_pieces_phase
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 16)()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in (96, 192):
        g = t2.default_g(c)
        x = t2.image(c)
        h, w = t2.shape(c)
        exp2 = (h // 6) * (w // 6) // g * (c // 16) * (36 * g) ** 2
        print(f"T2 C={c} G={g}: {exp2:.4g} exp2 a call (pieces 3, 4); at 16 a clock an SM, "
              f"{sms} SMs, {mhz:.0f} MHz: {exp2 / (16 * sms * mhz * 1e6) * 1e3:.3f} ms", flush=True)
        for name in names:
            v = t2.variant(name)
            wts = t2.weights(c, g, v["dense_int8"])
            packed = probes.pack_pieces(*wts[:8], *wts[9:], dense_int8=v["dense_int8"])
            kw = dict(G=g, rh=t2.RH, cw=t2.default_cw(c), **v)
            ms = time_ms(lambda: probes.swin_pieces(x, *wts, packed=packed, **kw), 5)
            torch.cuda.synchronize()
            _build.check(read(counts), "nunif_swin_pieces_phase")  # reset
            probes.swin_pieces(x, *wts, packed=packed, **kw)
            torch.cuda.synchronize()
            _build.check(read(counts), "nunif_swin_pieces_phase")
            tiles = counts[TILES]
            cycles = [counts[i] / tiles for i in range(len(PHASES))]
            print(f"T2 C={c} G={g} {name}: {ms:.3f} ms a call; cycles a tile: " + ", ".join(
                f"{p} {n:.0f}" for p, n in zip(PHASES, cycles) if n)
                + f"; sum {sum(cycles):.0f}", flush=True)
        del x


def main(names) -> int:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "nunif_tpu_torch", COPY / "nunif_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "nunif_tpu_torch" / "csrc" / "probe_swin_pieces.cu"
    cu.write_text(instrument(cu.read_text()))
    return subprocess.run([sys.executable, __file__, "--child", *names],
                          cwd=COPY).returncode


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2:])
    else:
        sys.exit(main(sys.argv[1:] or list(DEFAULT)))
