"""waifu2x turbo_2x / turbo_4x, NHWC (counterpart of
``nunif_tpu/waifu2x/models/turbo.py``).

A fixed catrom base plus a learned residual, both at half resolution:
- the base is a fixed 6x6 stride-2 conv that emits the (2s)^2 output
  subpixels of each half-res cell as channels, in true fp32 (TF32 is off,
  ``core/dtypes.py``); each of its output channels reads one input channel,
  so it runs as a grouped conv (``groups=C``) that skips the zeros;
- the learned path is a 6x6 stride-2 stem, ``blocks`` residual blocks of
  two 3x3 convs at width ``dim`` and a 3x3 tail to (2s)^2 * C channels, in
  x's dtype, rounded as flax rounds (conv, then the bias added in x's
  dtype);
- ``pre_shuffle`` returns the (H/2, W/2, (2s)^2 * C) head output, channel
  c * (2s)^2 + ry * 2s + rx, which the renderer blends and shuffles once
  after quantizing (``i2i_ps_factor`` 2s).

Convs run cuDNN on channels_last views; the model has no hand-written
kernel, as the JAX model has no Pallas kernel.  Layer names give the flax
paths ``stem/…``, ``body/block{i}_conv{1,2}/…`` and ``tail/…``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import dtypes  # noqa: F401  (TF32 off: the base is fp32)
from ...core.profiling import phase
from ...models import I2IBaseModel, init_flax_default, register_model
from ...modules.conv import conv2d
from ...modules.permute import pixel_shuffle


def _catrom_w(d, a=-0.5):
    d = abs(d)
    if d < 1.0:
        return (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1
    if d < 2.0:
        return a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a
    return 0.0


def catrom2x_phase_taps(scale: int = 2) -> np.ndarray:
    """(2 * scale, 6): weight of full-res row 2i - 2 + k, k = 0..5, for
    output row 2 * scale * i + r (align_corners=False: output j samples
    input (j + 0.5) / scale - 0.5)."""
    ph = 2 * scale
    m = np.zeros((ph, 6), np.float32)
    for r in range(ph):
        pos = (r + 0.5) / scale - 0.5
        for k in range(6):
            m[r, k] = _catrom_w(pos - (k - 2))
    return m


def catrom2x_halfres_kernel(channels: int = 3, scale: int = 2) -> np.ndarray:
    """Fixed (6, 6, C, (2 * scale)^2 * C) HWIO stride-2 kernel of the catrom
    ``scale``x upscale, output channel c * ph^2 + ry * ph + rx (ph = 2 *
    scale) reading input channel c only."""
    taps = catrom2x_phase_taps(scale)
    ph = 2 * scale
    k = np.zeros((6, 6, channels, ph * ph * channels), np.float32)
    for ry in range(ph):
        for rx in range(ph):
            kk = np.outer(taps[ry], taps[rx])
            for c in range(channels):
                k[:, :, c, c * ph * ph + ry * ph + rx] = kk
    return k


def catrom_grouped_weight(channels: int = 3, scale: int = 2) -> torch.Tensor:
    """``catrom2x_halfres_kernel`` as the weight of a ``groups=channels``
    conv: ((2 * scale)^2 * C, 1, 6, 6), output o reading input o // ph^2."""
    k = catrom2x_halfres_kernel(channels, scale)
    ph2 = (2 * scale) ** 2
    w = np.stack([k[:, :, o // ph2, o] for o in range(k.shape[-1])])
    return torch.from_numpy(np.ascontiguousarray(w[:, None]))


class _TurboBody(nn.Module):
    """conv -> relu -> conv + skip, ``blocks`` times (flax path ``body``)."""

    def __init__(self, dim: int, blocks: int):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"block{i}_conv1", nn.Conv2d(dim, dim, 3))
            setattr(self, f"block{i}_conv2", nn.Conv2d(dim, dim, 3))

    def forward(self, h):
        for i in range(self.blocks):
            r = F.relu(conv2d(h, getattr(self, f"block{i}_conv1"), padding=1))
            h = h + conv2d(r, getattr(self, f"block{i}_conv2"), padding=1)
        return h


@register_model
class Turbo2x(I2IBaseModel):
    """2x: fixed half-res catrom base + half-res residual CNN."""
    model_name = "waifu2x.turbo_2x"

    i2i_scale = 2
    i2i_offset = 16
    i2i_blend_size = 8
    i2i_ps_factor = 4  # head layout (H/2, W/2, C*16)
    i2i_default_tile_size = 256
    i2i_default_batch_size = 8
    i2i_tile_constraints = ((2, 0),)  # the stride-2 stem takes even tiles

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 dim: int = 128, blocks: int = 8,
                 pre_shuffle_output: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dim = dim
        self.blocks = blocks
        self.pre_shuffle_output = pre_shuffle_output
        ph = 2 * self.i2i_scale
        self.stem = nn.Conv2d(in_channels, dim, 6)
        self.body = _TurboBody(dim, blocks)
        self.tail = nn.Conv2d(dim, ph * ph * in_channels, 3)
        self.register_buffer(
            "base_weight", catrom_grouped_weight(in_channels, self.i2i_scale),
            persistent=False)

    def forward(self, x, train: bool = False, pre_shuffle=None):
        """x (B, H, W, C) in the compute dtype -> fp32 (B, H*s - 2*offset,
        W*s - 2*offset, C), or with ``pre_shuffle`` the head layout."""
        if pre_shuffle is None:
            pre_shuffle = self.pre_shuffle_output
        _b, h, w, c = x.shape
        ph = 2 * self.i2i_scale
        xc = x.permute(0, 3, 1, 2)
        # the window of half-res cell i covers full-res rows 2i - 2 .. 2i + 3
        # (flax pads (2, 3)); on even sizes a symmetric pad of 2 gives the
        # same windows, the last reaching row H + 1, without a padded copy
        if h % 2 == 0 and w % 2 == 0:
            pad = 2
        else:
            xc, pad = F.pad(xc, (2, 3, 2, 3)), 0
        with phase("turbo.base"):  # a profile's split names it
            base = F.conv2d(xc.float(), self.base_weight, stride=2,
                            padding=pad, groups=c)
        hid = self.body(conv2d(xc, self.stem, stride=2, padding=pad))
        y = base + conv2d(hid, self.tail, padding=1).float()
        off = self.i2i_offset // ph  # in half-res cells
        y = y[:, :, off:h // 2 - off, off:w // 2 - off]
        if not train:
            y = y.clamp(0.0, 1.0)
        y = y.permute(0, 2, 3, 1)
        return y if pre_shuffle else pixel_shuffle(y, ph)


@register_model
class Turbo4x(Turbo2x):
    """4x: the same half-res body; the fixed catrom 4x base and the tail
    emit all 8x8 output subpixels of a half-res cell (``i2i_ps_factor`` 8).
    """
    model_name = "waifu2x.turbo_4x"

    i2i_scale = 4
    i2i_offset = 32
    i2i_blend_size = 16
    i2i_ps_factor = 8


@torch.no_grad()
def init_untrained(model: Turbo2x, generator: torch.Generator) -> Turbo2x:
    """The JAX model's init: flax's default for the stem and each block's
    first conv, zeros for each block's second conv and the tail, so that an
    untrained model is the catrom base."""
    init_flax_default(model, generator)
    for name, p in model.named_parameters():
        if name.startswith("tail.") or "_conv2." in name:
            p.zero_()
    return model
