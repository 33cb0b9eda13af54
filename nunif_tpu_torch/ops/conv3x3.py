"""K2: 3x3 VALID conv + bias + optional leaky-ReLU + crop, NHWC.

Replaces ``nunif_tpu/ops/conv3x3.py:stem_conv3x3`` (a Pallas strip kernel
that keeps the im2col columns on chip).  The Hopper kernel is
``csrc/conv3x3.cu``; its header notes what bounds it on the H100 and what
its design does about that.  On swin_unet's main path it runs
``patch_conv1``: (1, 1118, 1934, 48) -> (1, 1104, 1920, 96), crop 6,
slope 0.1.

``stem_conv3x3`` takes its plain twin only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def stem_conv3x3_plain(x, kernel, bias, *, crop=0, lrelu_slope=None):
    """Plain PyTorch twin of ``stem_conv3x3``.

    Weights are rounded to x's dtype, the conv runs in fp32 on those values
    (exact products, fp32 sums, as the kernel's accumulator), then bias,
    leaky-ReLU and one rounding back to x's dtype.
    """
    dt = x.dtype
    c = crop
    if c:
        x = x[:, c:x.shape[1] - c, c:x.shape[2] - c, :]
    w = kernel.to(dt).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, bias.float())
    y = y.permute(0, 2, 3, 1)
    if lrelu_slope is not None:
        y = torch.where(y >= 0, y, y * lrelu_slope)
    return y.to(dt).contiguous()


def stem_conv3x3(x, kernel, bias, *, crop=0, lrelu_slope=None):
    """x (B, H, W, Cin); kernel (3, 3, Cin, Cout); bias (Cout,).

    Returns leaky_relu(conv3x3_valid(x) + bias)[:, crop:-crop, crop:-crop]
    of shape (B, H - 2 - 2 crop, W - 2 - 2 crop, Cout) in x's dtype
    (leaky-ReLU only when ``lrelu_slope`` is set).
    """
    if x.device.type == "cpu":
        return stem_conv3x3_plain(x, kernel, bias, crop=crop,
                                  lrelu_slope=lrelu_slope)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv3x3: unsupported device {x.device}")
    code = _build.dtype_code(x.dtype)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"stem_conv3x3: x must be contiguous NHWC, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, H, W, cin = x.shape
    if kernel.shape[:3] != (3, 3, cin) or kernel.dim() != 4:
        raise ValueError(f"stem_conv3x3: kernel {tuple(kernel.shape)} "
                         f"does not match Cin={cin}")
    cout = kernel.shape[3]
    if bias.shape != (cout,):
        raise ValueError(f"stem_conv3x3: bias {tuple(bias.shape)} != ({cout},)")
    if cin % 16 or cout % 16:
        raise ValueError(f"stem_conv3x3: Cin={cin} and Cout={cout} must be "
                         "multiples of 16 (MMA tiles)")
    ho, wo = H - 2 - 2 * crop, W - 2 - 2 * crop
    if crop < 0 or ho <= 0 or wo <= 0:
        raise ValueError(f"stem_conv3x3: {H}x{W} too small for crop {crop}")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"stem_conv3x3: {name} on {t.device}, x on {x.device}")
    wmat = kernel.to(x.dtype).reshape(9 * cin, cout).contiguous()
    if x.dtype == torch.bfloat16:
        wmat = _build.mma_weight_layout(wmat)
    b = bias.float().contiguous()
    if x.data_ptr() % 16 or wmat.data_ptr() % 32:
        raise ValueError("stem_conv3x3: x must be 16-byte and the kernel "
                         "32-byte aligned")
    out = torch.empty((B, ho, wo, cout), dtype=x.dtype, device=x.device)
    rc = _build.library().nunif_stem_conv3x3(
        code, x.data_ptr(), wmat.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, H, W, cin, cout, crop, int(lrelu_slope is not None),
        float(lrelu_slope or 0.0), _build.stream_ptr(x.device))
    _build.check(rc, "stem_conv3x3")
    stem_conv3x3.launches += 1
    return out


stem_conv3x3.launches = 0
