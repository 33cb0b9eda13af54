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


def time_rounds(fn, iters: int, rounds: int = 3) -> list:
    """Milliseconds a call in each of ``rounds`` rounds: CUDA events around
    ``iters`` calls, after a warm call."""
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
    return times


def time_ms(fn, iters: int, rounds: int = 3) -> float:
    """Milliseconds a call: the median of ``time_rounds``."""
    return statistics.median(time_rounds(fn, iters, rounds))


# device_ms's calibration kernel: torch.cuda._sleep cycles, ~1 ms
SPIN_CYCLES = 2_000_000


def device_ms(fn, n: int = 20, tries: int = 5):
    """Device ms a call: torch.profiler's summed device time over n calls
    after a warm one, divided by n (no host time, no gaps).  On the card's
    machine the profiler now and then drops kernel records (often in a
    long process), and its durations stray from CUDA events' by a few
    percent; so a session counts only if it recorded a kernel for every
    launch (at least one a call), and it carries a calibration: a spin
    kernel of about a millisecond timed by CUDA events (queued behind a
    longer one, so no host time falls between them).  Where the profiler
    records that kernel more than 2% shorter or longer, the sum is scaled
    by the events' time over the profiler's, and a line says so.  None
    after ``tries`` incomplete sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(4 * SPIN_CYCLES)  # covers the host's lag
            start.record()
            torch.cuda._sleep(SPIN_CYCLES)
            end.record()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if str(e.device_type).endswith("CUDA")]
        kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
        launches = max(n + 2, sum("LaunchKernel" in e.name for e in events
                                  if not str(e.device_type).endswith("CUDA")))
        spins = [e.time_range.elapsed_us() for e in kernels if "spin_kernel" in e.name]
        if len(kernels) < launches or len(spins) != 2:
            print(f"profiler: a session recorded {len(kernels)} kernels of "
                  f"{launches} launched", flush=True)
            continue
        total = sum(e.time_range.elapsed_us() for e in dev
                    if "spin_kernel" not in e.name)
        scale = start.elapsed_time(end) * 1e3 / spins[1]
        if abs(scale - 1) > 0.02:
            print(f"profiler: a {spins[1]:.1f} us spin kernel took "
                  f"{start.elapsed_time(end) * 1e3:.1f} us by CUDA events: "
                  f"device time scaled by {scale:.4f}", flush=True)
            total *= scale
        return total / n / 1e3
    return None
