"""Where a window of T3's kernel spends its time, on the card.

Copies ``nunif_tpu_torch/`` to ``build/window_dots_phases/`` and adds
``clock64()`` counters to the copy's ``csrc/probe_window_ring.cu``: lane 0
of each consumer group's first warp adds the cycles of each phase of a
window to a ``__device__`` array: the wait for the window's copies, the
first product with the row maxima of the warp's own columns, the wait at
the group's first barrier, e and its rounding into shared memory, the wait
at the second barrier, and the second product with the output's stores; an
added C entry point reads the array back.  The copy builds into its own
``build/`` and runs T3 at ``tools/microbench_int8_attn.py``'s shapes, bf16
and int8.  Prints ms a call (CUDA events, 8 calls, median of 3) and cycles
a window by phase, averaged over the windows.  The counters add a few
atomics a window: compare phases with each other, and take kernel times
from ``chip_smoke.py``.

Usage: python -m nunif_tpu_torch.tools.window_dots_phases   (card only)
"""
from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
COPY = ROOT / "build" / "window_dots_phases"
PHASES = ("copies", "product 1 + own maxima", "barrier 1", "e", "barrier 2",
          "product 2 + stores")
WINDOWS = 15


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"probe_window_ring.cu has changed; not found: {old!r}")
    return src.replace(old, new, 1)


def _stamp(i: int) -> str:
    return (f"    if (rec) {{ const long long now = clock64(); atomicAdd(&g_phase[{i}], "
            "(unsigned long long)(now - t_last)); t_last = now; }\n")


def instrument(src: str) -> str:
    """probe_window_ring.cu with the counters added."""
    src = _sub(src, '#include "wgmma.cuh"\n',
               '#include "wgmma.cuh"\n__device__ unsigned long long g_phase[16];\n')
    src = _sub(src, "  int k = gi;\n",
               "  int k = gi;\n  const bool rec = gw == 0 && lane == 0;\n"
               "  long long t_last = clock64();\n")
    src = _sub(src, "    mbar_wait(&full[s], (k / p.stages) & 1);\n",
               "    t_last = clock64();\n"
               "    mbar_wait(&full[s], (k / p.stages) & 1);\n" + _stamp(0)
               + f"    if (rec) atomicAdd(&g_phase[{WINDOWS}], 1ull);\n")
    for bar, first in (("bar1", 1), ("bar2", 3)):
        line = f"    named_bar_sync({bar}, group_threads);\n"
        src = _sub(src, line, _stamp(first) + line + _stamp(first + 1))
    src = _sub(src, "    if (lane == 0) mbar_arrive(&empty[s]);\n",
               "    if (lane == 0) mbar_arrive(&empty[s]);\n" + _stamp(5))
    return src + """
extern "C" int nunif_window_dots_phase(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
"""


def child() -> None:
    """In the copy: time T3 at the tool's shapes and print cycles a window
    by phase."""
    import ctypes
    sys.path.insert(0, str(COPY))
    import torch
    from nunif_tpu_torch.ops import _build, probes
    from nunif_tpu_torch.tools import microbench_int8_attn, require_cuda, time_ms
    assert probes.__file__.startswith(str(COPY)), probes.__file__
    print(f"devices: {require_cuda()}", flush=True)
    read = _build.library().nunif_window_dots_phase
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 16)()
    for dtype in (torch.bfloat16, torch.int8):
        ins = microbench_int8_attn.inputs(dtype)
        ms = time_ms(lambda: probes.window_dots(*ins), 8)
        torch.cuda.synchronize()
        _build.check(read(counts), "nunif_window_dots_phase")  # reset
        probes.window_dots(*ins)
        torch.cuda.synchronize()
        _build.check(read(counts), "nunif_window_dots_phase")
        windows = counts[WINDOWS]
        cycles = [counts[i] / windows for i in range(len(PHASES))]
        print(f"T3 {str(dtype).split('.')[1]} ({ins[0].shape[0]} windows): {ms:.3f} "
              f"ms a call; cycles a window of a consumer group: " + ", ".join(
                  f"{name} {v:.0f}" for name, v in zip(PHASES, cycles))
              + f"; sum {sum(cycles):.0f}", flush=True)
        del ins


def main() -> int:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "nunif_tpu_torch", COPY / "nunif_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "nunif_tpu_torch" / "csrc" / "probe_window_ring.cu"
    cu.write_text(instrument(cu.read_text()))
    return subprocess.run([sys.executable, __file__, "--child"],
                          cwd=COPY).returncode


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        sys.exit(main())
