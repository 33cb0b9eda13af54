"""Device selection (counterpart of ``nunif_tpu/core/device.py``).

The port runs on CUDA.  Asking for a CUDA device where there is none is an
error, never a silent move to the CPU; the CPU is used only when a caller
names it (the parity tests do).
"""
import torch


def resolve_device(name="cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            "(pass device='cpu' to run the plain PyTorch twins on the CPU)")
    return device
