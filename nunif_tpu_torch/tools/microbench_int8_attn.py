"""T3 on the card: the per-window attention dot pair in bf16 against int8
(the question of ``tools/microbench_int8_attn.py``).

Streams nw = 14720 windows (the 1104x1920 grid) of head-packed attention
shapes through ``ops/probes.py:window_dots``: q (36, 96), khat (96, 216),
vhat (216, 104).  Prints ms and ns/window as the JAX tool does, beside the
plain twin and, in bf16, the torch.bmm pair (int8 has no batched PyTorch
product).

Usage: python -m nunif_tpu_torch.tools.microbench_int8_attn
"""
from __future__ import annotations

from . import require_cuda, time_ms

N, C, P, CV, NW = 36, 96, 216, 104, 14720


def inputs(dtype, nw=NW, seed=0):
    """q, khat, vhat as the tool draws them: uniform [-1, 1) bf16 or int8
    in [-127, 127), made on the device."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((nw, N, C), (nw, C, P), (nw, P, CV))
    if dtype == torch.int8:
        return [torch.randint(-127, 127, s, generator=gen, device="cuda",
                              dtype=torch.int8) for s in shapes]
    return [(torch.rand(s, generator=gen, device="cuda") * 2 - 1).to(dtype)
            for s in shapes]


def bmm_pair(q, khat, vhat):
    """The library yardstick: two cuBLAS batched products in bf16 with the
    exp2 step between them as PyTorch ops."""
    import torch
    s = torch.bmm(q, khat).float()
    e = torch.exp2(torch.clamp_min(s - s.amax(-1, keepdim=True), -100.0))
    return torch.bmm(e.to(q.dtype), vhat)[:, :, :C]


def bench(dtype, label, nw=NW) -> dict:
    import torch
    from ..ops import probes
    q, khat, vhat = inputs(dtype, nw)
    ms = None
    for iters in (2, 8):
        ms = time_ms(lambda: probes.window_dots(q, khat, vhat), iters)
        print(f"{label:24s} iters={iters}: {ms:8.2f} ms  "
              f"({ms * 1e6 / nw:6.0f} ns/window)", flush=True)
    plain = time_ms(lambda: probes.window_dots_plain(q, khat, vhat), 2)
    lib = None
    if dtype == torch.bfloat16:
        lib = time_ms(lambda: bmm_pair(q, khat, vhat), 8)
    print(f"{label:24s} plain twin {plain:.2f} ms; torch.bmm pair "
          f"{'none (no int8 bmm)' if lib is None else f'{lib:.2f} ms'}",
          flush=True)
    nbytes = sum(t.numel() * t.element_size() for t in (q, khat, vhat)) \
        + nw * N * C * 2
    return dict(ms=ms, plain_ms=plain, library_ms=lib, nbytes=nbytes,
                flops=2 * nw * (N * C * P + N * P * C))


def run() -> dict:
    import torch
    print(f"devices: {require_cuda()}", flush=True)
    return {"bf16": bench(torch.bfloat16, "bf16 headpack dots"),
            "int8": bench(torch.int8, "int8 headpack dots")}


if __name__ == "__main__":
    run()
