"""Build and load the hand-written CUDA kernels in ``nunif_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The library lands in ``build/nunif_tpu_torch/`` at
the repository root, keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the previous build.  Nothing here runs
at import time: CPU-only installs import every module without a toolkit.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "nunif_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_F32 = 0
DTYPE_BF16 = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # dtype, x, w, bias, out, B, H, W, Cin, Cout, crop, has_slope, slope, stream
    "nunif_stem_conv3x3": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, x, skip, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
    # relbias, out, B, H, W, C, heads, hidden, ws, shift, scale, stream
    "nunif_swin_block_image": [_I] + [_P] * 12 + [_I] * 8 + [_F, _P],
    # x, delta, out, B, H, W, C, stream
    "nunif_warp_x_bounded": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, B, H, N, M, D, (batch, head, row) strides of q, k, v,
    # out, scale, stream
    "nunif_flash_attn": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_F, _P],
}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    return srcs, headers


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the library if this source hash has no build yet.

    Returns (path, seconds spent compiling, compiler log); seconds is 0.0
    when an existing build was reused.
    """
    srcs, headers = _sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources in {CSRC_DIR}")
    lib = BUILD_DIR / f"libnunif_tpu_torch_{_digest(srcs + headers)}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(tmp),
           *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed (rc {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _seconds, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nunif_error_string.argtypes = [_I]
    lib.nunif_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        text = library().nunif_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({text})")


def mma_weight_layout(w):
    """(K, N) bf16 weight -> the kernels' mma.sync m16n8k16 B fragments,
    shape (K/16, N/8, 32, 4): lane 4g + t of the fragment for k-step ks and
    8-column tile j holds W[16 ks + 2t + (0, 1, 8, 9)][8 j + g], so a kernel
    fetches a whole fragment with one 8-byte load per lane."""
    k, n = w.shape
    return (w.reshape(k // 16, 2, 4, 2, n // 8, 8)
            .permute(0, 4, 5, 2, 1, 3).reshape(k // 16, n // 8, 32, 4)
            .contiguous())


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    import torch
    if dtype == torch.bfloat16:
        return DTYPE_BF16
    if dtype == torch.float32:
        return DTYPE_F32
    raise TypeError(f"kernel takes bfloat16 or float32, not {dtype}")
