"""Stride-1 pooling on NHWC tensors (counterpart of
``nunif_tpu/modules/pool.py``): padding k // 2; padded cells never win a
max or min and are not counted in an average."""
import torch
import torch.nn.functional as F


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def max_pool2d(x: torch.Tensor, kernel_size) -> torch.Tensor:
    kh, kw = _pair(kernel_size)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), stride=1,
                     padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def min_pool2d(x: torch.Tensor, kernel_size) -> torch.Tensor:
    return -max_pool2d(-x, kernel_size)


def avg_pool2d(x: torch.Tensor, kernel_size) -> torch.Tensor:
    """Mean over the window's cells inside the image
    (``count_include_pad=False``), summed in fp32, in x's dtype."""
    kh, kw = _pair(kernel_size)
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), (kh, kw), stride=1,
                     padding=(kh // 2, kw // 2), count_include_pad=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def box_blur(x: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    return avg_pool2d(x, kernel_size)
