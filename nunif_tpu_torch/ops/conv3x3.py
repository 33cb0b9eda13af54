"""K2: 3x3 VALID conv + bias + optional leaky-ReLU + crop, NHWC.

Replaces ``nunif_tpu/ops/conv3x3.py:stem_conv3x3`` (a Pallas strip kernel
that keeps the im2col columns on chip).  The Hopper kernel is
``csrc/conv3x3.cu``; its header notes what bounds it on the H100 and what
its design does about that.  On swin_unet's main path it runs
``patch_conv1``: (1, 1118, 1934, 48) -> (1, 1104, 1920, 96) on the 2x
model and (1, 590, 974, 96) -> (1, 576, 960, 192) on the 4xl, crop 6,
slope 0.1.

In bf16 the kernel is a persistent wgmma kernel: each block holds one
column group of ``column_group(Cout)`` output channels of the weights in
shared memory and walks output rows of 64 pixels.  It reads the weights in
the layout ``pack_stem_weights`` makes, which a caller packs once per
weight load and passes as ``packed`` (``Im2ColConv3x3`` in
``waifu2x/models/swin_unet.py`` caches it); without ``packed`` the wrapper
packs on every call.  In fp32 the kernel reads the plain (9 Cin, Cout)
matrix.

``stem_conv3x3`` takes its plain twin only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# column-group widths the bf16 kernel is built for (csrc/wgmma.cuh)
COLUMN_GROUPS = (96, 48, 32, 16)


def stem_conv3x3_plain(x, kernel, bias, *, crop=0, lrelu_slope=None,
                       packed=None):
    """Plain PyTorch twin of ``stem_conv3x3``.

    Weights are rounded to x's dtype, the conv runs in fp32 on those values
    (exact products, fp32 sums, as the kernel's accumulator), then bias,
    leaky-ReLU and one rounding back to x's dtype.  ``packed`` is the
    kernel's form of the weights, which the twin does not read.
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


def column_group(cout: int) -> int:
    """Output channels a block of the bf16 kernel owns: the widest of
    ``COLUMN_GROUPS`` that divides ``cout`` (a multiple of 16)."""
    return next(n for n in COLUMN_GROUPS if cout % n == 0)


def pack_stem_weights(kernel, dtype):
    """The kernel's form of a (3, 3, Cin, Cout) HWIO kernel for x of
    ``dtype``.

    fp32: the (9 Cin, Cout) matrix W = kernel.reshape(9 Cin, Cout).  bf16:
    W rounded to bf16 and laid out as wgmma's K-major B operand, one column
    group of NB = ``column_group(Cout)`` channels after another, shape
    (Cout / NB, 9 Cin / 16, NB / 8, 2, 8, 8), with

        packed[h, ks, nb, kb, r, c] = W[16 ks + 8 kb + c, NB h + 8 nb + r]

    (for k16 step ks: two 8 x 8 core matrices along K, NB / 8 along N; a
    core matrix is 8 columns of 8 consecutive k values, 128 bytes).
    """
    cin, cout = kernel.shape[2], kernel.shape[3]
    w = kernel.detach().to(dtype).reshape(9 * cin, cout)
    if dtype != torch.bfloat16:
        return w.contiguous()
    return _build.wgmma_weight_layout(w, column_group(cout))


def _packed_shape(cin, cout, dtype):
    if dtype != torch.bfloat16:
        return (9 * cin, cout)
    nb = column_group(cout)
    return (cout // nb, 9 * cin // 16, nb // 8, 2, 8, 8)


def stem_conv3x3(x, kernel, bias, *, crop=0, lrelu_slope=None, packed=None):
    """x (B, H, W, Cin); kernel (3, 3, Cin, Cout); bias (Cout,).

    Returns leaky_relu(conv3x3_valid(x) + bias)[:, crop:-crop, crop:-crop]
    of shape (B, H - 2 - 2 crop, W - 2 - 2 crop, Cout) in x's dtype
    (leaky-ReLU only when ``lrelu_slope`` is set).  ``packed`` is an
    optional ``(pack_stem_weights(kernel, x.dtype), bias as fp32)`` pair;
    the kernel reads it in place of ``kernel`` and ``bias``, and the CPU
    twin ignores it.
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
    if packed is None:
        packed = (pack_stem_weights(kernel, x.dtype),
                  bias.detach().float().contiguous())
    wmat, b = packed
    want = _packed_shape(cin, cout, x.dtype)
    if (tuple(wmat.shape) != want or wmat.dtype != x.dtype
            or b.shape != (cout,) or b.dtype != torch.float32
            or not (wmat.is_contiguous() and b.is_contiguous())):
        raise ValueError(f"stem_conv3x3: packed weights {tuple(wmat.shape)} "
                         f"{wmat.dtype} are not packed for {want} {x.dtype}")
    for name, t in (("kernel", wmat), ("bias", b)):
        if t.device != x.device:
            raise ValueError(f"stem_conv3x3: {name} on {t.device}, x on {x.device}")
    if x.data_ptr() % 16 or wmat.data_ptr() % 16:
        raise ValueError("stem_conv3x3: x and the kernel must be 16-byte "
                         "aligned")
    out = torch.empty((B, ho, wo, cout), dtype=x.dtype, device=x.device)
    rc = _build.library().nunif_stem_conv3x3(
        code, x.data_ptr(), wmat.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, H, W, cin, cout, column_group(cout), crop,
        int(lrelu_slope is not None), float(lrelu_slope or 0.0),
        _build.stream_ptr(x.device))
    _build.check(rc, "stem_conv3x3")
    stem_conv3x3.launches += 1
    return out


stem_conv3x3.launches = 0
