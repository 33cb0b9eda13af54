"""T4 on the card: the issue cost of small per-window attention dots, bf16
against int8, at the shape variants of ``tools/microbench_mxu_dots.py``.

``ops/probes.py:window_dots_repeat`` repeats each window's dot pair REPS
times on operands that stay on the chip, with a data dependency, over
1024 windows in blocks of 16.  Prints ns per window dot pair, beside the
plain twin and, in bf16, the same REPS loop of torch.bmm pairs.

With ``--chunk128`` it runs instead, once, the configuration that gave
NaNs until q's fragments were reloaded a chunk (bf16 at C = 128 with P in
chunks of 128, a plan only this switch sets) against the twin and prints
its NaN count and error.

Usage: python -m nunif_tpu_torch.tools.microbench_mxu_dots [index ...]
       python -m nunif_tpu_torch.tools.microbench_mxu_dots --chunk128
"""
from __future__ import annotations

import sys

from . import require_cuda, time_ms

NWIN = 1024
# (label, N, C, P, int8)
SHAPES = (
    ("bf16  N=36 C=96 P=216 (headpack)", 36, 96, 216, False),
    ("int8  N=36 C=96 P=216 (headpack)", 36, 96, 216, True),
    ("bf16  N=36 C=128 P=256 (padded)", 36, 128, 256, False),
    ("int8  N=36 C=128 P=256 (padded)", 36, 128, 256, True),
    ("bf16  N=108 C=96 P=216*3=648 (pack3)", 108, 96, 648, False),
    ("int8  N=108 C=96 P=648 (pack3)", 108, 96, 648, True),
    ("bf16  N=36 C=48 P=108 (hgroup3 x2)", 36, 48, 108, False),
    ("int8  N=36 C=48 P=108 (hgroup3 x2)", 36, 48, 108, True),
)


def inputs(n, c, p, int8, nwin=NWIN, seed=0):
    """q, khat, vhat as the tool draws them: uniform [0, 1) bf16 or int8 in
    [-127, 127), made on the device."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((nwin, n, c), (nwin, c, p), (nwin, p, c))
    if int8:
        return [torch.randint(-127, 127, s, generator=gen, device="cuda",
                              dtype=torch.int8) for s in shapes]
    return [torch.rand(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in shapes]


def bmm_repeat(q, khat, vhat):
    """The library yardstick: the REPS loop of bf16 torch.bmm pairs with the
    carry step between them as PyTorch ops."""
    import torch
    from ..ops.probes import BLOCK_WINDOWS as bw, REPS as reps
    carry = torch.zeros(q.shape[0] // bw, device=q.device)
    for _ in range(reps):
        s = torch.bmm(q, khat).float()
        e = (s + carry.repeat_interleave(bw)[:, None, None]).to(q.dtype)
        o = torch.bmm(e, vhat)
        carry = carry * 0 + o[::bw, 0, 0].float() * 1e-30
    return carry


def bench(label, n, c, p, int8, nwin=NWIN) -> dict:
    from ..ops import probes
    q, khat, vhat = inputs(n, c, p, int8, nwin)
    packed = probes.pack_dots(khat, vhat)
    ms = time_ms(lambda: probes.window_dots_repeat(q, khat, vhat,
                                                   packed=packed), 1)
    per = ms * 1e6 / (probes.REPS * nwin)
    print(f"{label:44s} {per:8.0f} ns/window-dotpair", flush=True)
    plain = time_ms(lambda: probes.window_dots_repeat_plain(q, khat, vhat), 1,
                    rounds=1)
    lib = None if int8 else time_ms(
        lambda: bmm_repeat(q, khat, vhat), 1)
    print(f"{'':44s} plain twin {plain:.3f} ms; torch.bmm pairs "
          f"{'none (no int8 bmm)' if lib is None else f'{lib:.3f} ms'}; "
          f"kernel {ms:.3f} ms", flush=True)
    nbytes = sum(t.numel() * t.element_size() for t in (q, khat, vhat)) \
        + 8 * 128 * 4
    return dict(label=label, ms=ms, ns=per, plain_ms=plain, library_ms=lib,
                flops=2 * 2 * n * c * p * probes.REPS * nwin, nbytes=nbytes,
                int8=int8)


def run(select=None) -> list:
    from ..ops import probes
    print(f"device: {require_cuda()}, reps={probes.REPS}, "
          f"bw={probes.BLOCK_WINDOWS}", flush=True)
    return [bench(*shape) for i, shape in enumerate(SHAPES)
            if select is None or i in select]


def chunk128() -> dict:
    """bf16 N 36 C 128 P 256 in chunks of 128 (the test hook), once, with
    the per-window check against the twin."""
    import torch
    from ..ops import _build, probes
    print(f"device: {require_cuda()}", flush=True)
    q, khat, vhat = inputs(36, 128, 256, False, seed=11)
    lib = _build.library()
    lib.nunif_window_dots_force_chunk128(1)
    try:
        print(f"plan: {probes.window_dots_plan(torch.bfloat16, 36, 128, 256)}",
              flush=True)
        check = torch.zeros((q.shape[0], 36, 128), device="cuda")
        got = probes.window_dots_repeat(q, khat, vhat, check=check)
        torch.cuda.synchronize()
    finally:
        lib.nunif_window_dots_force_chunk128(0)
    want_check = torch.zeros_like(check)
    want = probes.window_dots_repeat_plain(q, khat, vhat, want_check)
    out = dict(nan_out=int(got.isnan().sum()), nan_windows=int(check.isnan().sum()),
               windows_with_nan=int(check.isnan().flatten(1).any(1).sum()),
               max_abs_err=float((got - want).abs().nan_to_num(float("inf")).max()),
               max_abs_err_windows=float(
                   (check - want_check).abs().nan_to_num(float("inf")).max()))
    print(out, flush=True)
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["--chunk128"]:
        chunk128()
    else:
        run(set(int(a) for a in sys.argv[1:]) or None)
