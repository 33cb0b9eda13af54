"""Named ranges for ``torch.profiler`` (the frame split of
``chip_smoke.py`` reads them)."""
import contextlib

import torch
from torch.profiler import record_function


def phase(name: str):
    """A ``torch.profiler`` range named ``name`` while a profile records;
    otherwise nothing, so that a frame outside a profile pays for no
    range."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()
