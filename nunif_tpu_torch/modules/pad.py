"""Padding and cropping on NHWC tensors (counterpart of
``nunif_tpu/modules/pad.py``).  Pads are (left, right, top, bottom), the
order of torch's ``F.pad`` for the last two axes of NCHW."""
import torch
import torch.nn.functional as F


def _pad_nchw(x, pads, mode, value=0.0):
    y = x.permute(0, 3, 1, 2)
    if mode == "constant":
        y = F.pad(y, tuple(pads), mode="constant", value=value)
    else:
        y = F.pad(y, tuple(pads), mode=mode)
    return y.permute(0, 2, 3, 1)


def replication_pad2d(x: torch.Tensor, pads) -> torch.Tensor:
    return _pad_nchw(x, pads, "replicate")


def reflection_pad2d(x: torch.Tensor, pads) -> torch.Tensor:
    return _pad_nchw(x, pads, "reflect")


def zero_pad2d(x: torch.Tensor, pads) -> torch.Tensor:
    return _pad_nchw(x, pads, "constant")


def crop2d(x: torch.Tensor, crops) -> torch.Tensor:
    """Crop (left, right, top, bottom) pixels from H and W."""
    left, right, top, bottom = crops
    h, w = x.shape[-3], x.shape[-2]
    return x[..., top:h - bottom, left:w - right, :]
