"""LPIPS perceptual distance, VGG16 flavour, NHWC (counterpart of
``nunif_tpu/modules/lpips.py``).

The five VGG16 taps (relu1_2 ... relu5_3) of both images, each normalized
per pixel in fp32 (the norm fix: x rsqrt(sum x^2 + 1e-8)), the target's
detached, the squared difference weighted by the non-negative linear heads
(the reference's re-trained ``_lpips_2.pth``, bundled as
``_lpips_lins.npz``, the JAX package's copy) and averaged over the image.
The trunk's weights convert from a torchvision ``vgg16`` state dict
(``models.torch_convert.convert_vgg16_features``); without one it is a
seeded random trunk, which gives a training signal but not the reference's
numbers.  Plain PyTorch: the convolutions run on cuDNN.

``lpips_with``: base loss + weight * mean LPIPS, optionally through the
local-std gradient mask.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .conv import conv2d_nhwc
from .local_std_mask import local_std_mask

# VGG16 conv layout: (channels, convs a stage); LPIPS taps each stage's end
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)


class VGG16Features(nn.Module):
    """The VGG16 trunk (``conv0`` ... ``conv12``, 3x3 SAME, ReLU, 2x2 max
    pool between stages) returning the five tap activations."""

    def __init__(self):
        super().__init__()
        cin, k = 3, 0
        for ch, n in VGG_STAGES:
            for _ in range(n):
                self.add_module(f"conv{k}", nn.Conv2d(cin, ch, 3))
                cin, k = ch, k + 1

    def forward(self, x):
        taps, k = [], 0
        for si, (_ch, n) in enumerate(VGG_STAGES):
            for _ in range(n):
                x = torch.relu(conv2d_nhwc(x, getattr(self, f"conv{k}"), padding=1))
                k += 1
            taps.append(x)
            if si < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return taps


def _lins():
    lins = np.load(os.path.join(os.path.dirname(__file__), "_lpips_lins.npz"))
    return [lins[f"lin{i}"] for i in range(5)]


class LPIPS(nn.Module):
    """lpips(in0, in1) -> (B,): inputs in [-1, 1] (``normalize=True`` for
    [0, 1]).  The trunk is ``net``, so its flax paths are
    ``net/conv{k}/kernel``."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, lin in enumerate(_lins()):
            self.register_buffer(f"lin{i}", torch.from_numpy(lin), persistent=False)

    def forward(self, in0, in1, normalize: bool = False):
        if normalize:
            in0 = 2 * in0 - 1
            in1 = 2 * in1 - 1
        shift = torch.tensor(_SHIFT, dtype=in0.dtype, device=in0.device)
        scale = torch.tensor(_SCALE, dtype=in0.dtype, device=in0.device)
        outs0 = self.net((in0 - shift) / scale)
        outs1 = self.net((in1 - shift) / scale)
        val = 0.0
        for i, (f0, f1) in enumerate(zip(outs0, outs1)):
            f0 = f0.float()
            f1 = f1.float().detach()
            f0 = f0 * torch.rsqrt(torch.sum(f0 ** 2 + 1e-8, dim=-1, keepdim=True))
            f1 = f1 * torch.rsqrt(torch.sum(f1 ** 2 + 1e-8, dim=-1, keepdim=True))
            w = torch.clamp(getattr(self, f"lin{i}"), min=0.0)
            val = val + torch.mean(torch.sum((f0 - f1) ** 2 * w, dim=-1), dim=(1, 2))
        return val


def lpips_with(model: LPIPS, base_loss, weight=1.0, std_mask=False):
    """loss_fn(input, target) = base_loss + weight * mean LPIPS(input,
    target) on [0, 1] images, with ``model`` (its trunk frozen)."""
    def loss_fn(input, target):
        x = local_std_mask(input, target) if std_mask else input
        p = model(x, target, normalize=True)
        return base_loss(input, target) + weight * torch.mean(p)
    return loss_fn
