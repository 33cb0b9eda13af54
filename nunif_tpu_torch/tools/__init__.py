"""Hopper probes of the JAX package's ``tools/microbench_*`` questions.

Each module runs on the card only (``python -m
nunif_tpu_torch.tools.<name>``), names the card, times its kernels with
CUDA events and prints them beside their plain twins and, where there is
one, a PyTorch library call.
"""
from __future__ import annotations

import statistics


def require_cuda() -> str:
    """The card's name; raises without one (the probes have no CPU mode)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this probe needs a CUDA device")
    return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"


def time_ms(fn, iters: int, rounds: int = 3) -> float:
    """Milliseconds a call: CUDA events around ``iters`` calls after a warm
    call, median of ``rounds``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)
