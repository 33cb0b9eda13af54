"""iw3 inpainting discriminators, NHWC (counterpart of
``nunif_tpu/iw3/models/discriminator.py``).

``inpaint.l3_conditional_discriminator``: waifu2x's L3 PatchGAN stack
conditioned on the masked image (``ImageToCondition``);
``inpaint.ffc_discriminator``: strided conv stages each followed by a
Fourier-convolution block (LaMa style).  Given the hole mask, each returns
(logits, grid) where the grid marks the logit cells over the hole: the
mask max-pooled to the 8x-downsampled logits, dilated by a 3x3 max-pool
and border-cropped as the logits are.  The masked hinge loss counts only
those cells.  Plain PyTorch (cuDNN convolutions): the JAX models reach no
Pallas kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from ...models import Model, register_model
from ...modules.conv import conv2d_nhwc, leaky_relu
from ...modules.fourier_unit import FourierUnit
from ...modules.pad import crop2d, replication_pad2d
from ...modules.permute import pixel_unshuffle
from ...modules.pool import max_pool2d
from ...waifu2x.models.discriminator import (
    ImageToCondition, ResBlockGNLReLU, fit_to_size, group_norm, modcrop,
    normalize)


def mask_to_logit_grid(mask, logits_hw):
    """(B, H, W, 1) image mask -> (B, h, w, 1) bool grid aligned with the
    8x-downsampled, border-cropped logits."""
    m = pixel_unshuffle(mask, 8).amax(dim=-1, keepdim=True)
    m = crop2d(max_pool2d(m.float(), 3), (2,) * 4)
    if tuple(m.shape[1:3]) != tuple(logits_hw):
        raise ValueError(f"mask grid {tuple(m.shape[1:3])} != logits {logits_hw}")
    return m > 0


class FFCBlock(nn.Module):
    """x + fusion(cat(x, FourierUnit(x))): 1x1 conv, LeakyReLU(0.2),
    replication-padded 3x3 conv."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.ffc = FourierUnit(in_channels, in_channels, residual=False)
        self.fusion_0 = nn.Conv2d(in_channels * 2, in_channels, 1)
        self.fusion_3 = nn.Conv2d(in_channels, in_channels, 3)

    def forward(self, x):
        h = conv2d_nhwc(torch.cat([x, self.ffc(x)], dim=-1), self.fusion_0)
        h = leaky_relu(h, 0.2)
        h = conv2d_nhwc(replication_pad2d(h, (1, 1, 1, 1)), self.fusion_3)
        return x + h


STAGES = (64, 128, 256)


@register_model
class FFCDiscriminator(Model):
    model_name = "inpaint.ffc_discriminator"

    def __init__(self):
        super().__init__()
        cin = 3
        for i, ch in enumerate(STAGES):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 4))
            self.add_module(f"gn{i}", group_norm(ch))
            self.add_module(f"ffc{i}", FFCBlock(ch))
            cin = ch
        self.classifier = nn.Conv2d(cin, 1, 1)

    def forward(self, x, c=None, mask=None, train: bool = False):
        x = modcrop(x, 8)
        if mask is not None:
            mask = fit_to_size(x, mask)
        x = normalize(x)
        for i in range(len(STAGES)):
            x = conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)),
                            getattr(self, f"conv{i}"), stride=2)
            x = leaky_relu(getattr(self, f"gn{i}")(x), 0.2)
            x = getattr(self, f"ffc{i}")(x)
        x = crop2d(conv2d_nhwc(x, self.classifier), (2,) * 4)
        if mask is not None:
            return x, mask_to_logit_grid(mask, x.shape[1:3])
        return x


@register_model
class InpaintL3ConditionalDiscriminator(Model):
    model_name = "inpaint.l3_conditional_discriminator"

    def __init__(self):
        super().__init__()
        self.to_cond = ImageToCondition(32, (256,), 1)
        cin = 3
        for i, ch in enumerate(STAGES):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 4))
            self.add_module(f"gn{i}", group_norm(ch, min(32, ch)))
            cin = ch
        self.res = ResBlockGNLReLU(cin, cin)
        self.classifier = nn.Conv2d(cin, 1, 3)

    def forward(self, x, c=None, mask=None, train: bool = False):
        x = modcrop(x, 8)
        c = fit_to_size(x, c if c is not None else x)
        if mask is not None:
            mask = fit_to_size(x, mask)
        cond = self.to_cond(c)
        x = normalize(x)
        for i in range(len(STAGES)):
            x = conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)),
                            getattr(self, f"conv{i}"), stride=2)
            x = leaky_relu(getattr(self, f"gn{i}")(x), 0.2)
        x = self.res(x) + cond[0].to(x.dtype)
        x = crop2d(conv2d_nhwc(x, self.classifier, padding=1), (2,) * 4)
        if mask is not None:
            return x, mask_to_logit_grid(mask, x.shape[1:3])
        return x
