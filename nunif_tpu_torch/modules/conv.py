"""Convolution helpers (counterpart of ``nunif_tpu/modules/conv.py``)."""
import torch


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)
