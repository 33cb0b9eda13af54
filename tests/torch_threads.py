"""Each pytest-xdist worker takes its share of PyTorch's intra-op threads.

PyTorch starts one intra-op thread a core in every process.  Under ``-n
N`` that is N threads a core, and OpenMP's spinning threads then take
turns on the cores: the six heaviest parity files ran about twice as long
in six workers as with one thread a worker, for the same work.  Imported
by every ``tests/test_torch_*.py``; outside an xdist run it changes
nothing.
"""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, torch.get_num_threads() // _workers))
