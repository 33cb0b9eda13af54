"""Build and load the hand-written CUDA kernels in ``nunif_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The library lands in ``build/nunif_tpu_torch/`` at
the repository root, keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the previous build.  Nothing here runs
at import time: CPU-only installs import every module without a toolkit.

Every C entry point returns ``cudaGetLastError()`` after its launch, or
the first failing CUDA or driver code before it; ``check`` turns a non-zero
code into an exception.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

DTYPE_F32 = 0
DTYPE_BF16 = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # dtype, x, w, bias, out, B, H, W, Cin, Cout, nb, crop, has_slope, slope,
    # stream
    "nunif_stem_conv3x3": [_I, _P, _P, _P, _P] + [_I] * 8 + [_F, _P],
    # dtype, x, skip, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2,
    # relbias, out, B, H, W, C, heads, hidden, ws, shift, chunk, scale, stream
    "nunif_swin_block_image": [_I] + [_P] * 12 + [_I] * 9 + [_F, _P],
    # C, hidden, ws, chunk, int out[5]
    "nunif_swin_block_plan": [_I, _I, _I, _I, _P],
    # dtype, x, delta, out, B, H, W, C, max_shift, stream
    "nunif_warp_x_bounded": [_I, _P, _P, _P] + [_I] * 5 + [_P],
    # W, C, dtype, max_shift, int out[5]
    "nunif_warp_x_plan": [_I] * 4 + [_P],
    # q, k, v, out, B, H, N, M, D, (batch, head, row) strides of q, k, v,
    # out, scale, stream
    "nunif_flash_attn": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_F, _P],
    # dtype, qkv, relbias, out, nw, N, C, heads, ws, shift, n_wh, n_ww,
    # scale, stream
    "nunif_window_attn": [_I, _P, _P, _P] + [_I] * 8 + [_F, _P],
    # dtype, x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, relbias,
    # out, nw, C, heads, hidden, ws, shift, pad_mode, n_wh, n_ww, chunk,
    # scale, stream
    "nunif_swin_block_windows": [_I] + [_P] * 11 + [_I] * 10 + [_F, _P],
    # dtype, qkv, relbias, out, B, H, W, C, heads, ws, shift, scale, stream
    "nunif_window_attn_image": [_I, _P, _P, _P] + [_I] * 7 + [_F, _P],
    # C, heads, N, nw, sms, int out[7]
    "nunif_window_attn_plan": [_I] * 5 + [_P],
    # relayout, x, out, windows, H, W, C, ws, rh, cw, scale, stream
    "nunif_strip": [_I, _P, _P, _P] + [_I] * 6 + [_F, _P],
    # H, W, C, ws, rh, cw, sms, int out[7]
    "nunif_strip_plan": [_I] * 7 + [_P],
    # dtype, q, khat, vhat, out, nw, N, C, P, Cv, Cout, stream
    "nunif_window_dots": [_I] + [_P] * 4 + [_I] * 6 + [_P],
    # dtype, q, kt, vt, out, check, nw, N, C, P, reps, bw, stream
    "nunif_window_dots_repeat": [_I] + [_P] * 5 + [_I] * 6 + [_P],
    # dtype, N, C, P, int out[9]
    "nunif_window_dots_plan": [_I] * 4 + [_P],
    # on (T4's test-only bf16 chunk-128 plan)
    "nunif_window_dots_force_chunk128": [_I],
    # x, (w, b, s) of qkv, proj, fc1, fc2, bias, out, H, W, C, G, rh, cw,
    # pieces, dense_int8, scores_int8, w_scale, cut, qscale, eps, inv127,
    # stream
    "nunif_swin_pieces": [_P] * 15 + [_I] * 9 + [_F] * 5 + [_P],
    # C, G, int out[8]
    "nunif_swin_pieces_plan": [_I, _I, _P],
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
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = lib.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    compiles = [[nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in compiles]
    outputs = [proc.communicate() for proc in procs]
    log = "".join(f"$ {' '.join(cmd)}\n{out}{err}"
                  for cmd, (out, err) in zip(compiles, outputs))
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}"
        failed = [proc.returncode] if proc.returncode != 0 else []
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed (rc {failed[0]}):\n{log}")
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


def wgmma_weight_layout(w, nb):
    """(K, N) bf16 or int8 weight -> wgmma's K-major B operand in shared
    memory, unswizzled, one group of ``nb`` columns after another.  A core
    matrix is 8 columns of E = 16 bytes of consecutive k values (E = 8
    bf16, 16 int8), and a wgmma k step (k16 in bf16, k32 in int8) is two of
    them along K: shape (N / nb, K / 2E, nb / 8, 2, 8, E) with

        packed[h, ks, n8, kb, r, c] = w[2E ks + E kb + c, nb h + 8 n8 + r]

    (core matrices 128 bytes apart along K, 256 along N).  Any run of k
    steps of one column group is contiguous, ``nb`` * 32 bytes a step in
    either type."""
    k, n = w.shape
    e = 16 // w.element_size()
    return (w.reshape(k // (2 * e), 2, e, n // nb, nb // 8, 8)
            .permute(3, 0, 4, 1, 5, 2).contiguous())


def stream_ptr(device) -> int:
    """The current stream's raw handle on ``device``, through PyTorch's own
    accessor (~7 us cheaper a call than ``current_stream().cuda_stream``,
    which builds a Stream object)."""
    import torch
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def dtype_code(dtype) -> int:
    import torch
    if dtype == torch.bfloat16:
        return DTYPE_BF16
    if dtype == torch.float32:
        return DTYPE_F32
    raise TypeError(f"kernel takes bfloat16 or float32, not {dtype}")
