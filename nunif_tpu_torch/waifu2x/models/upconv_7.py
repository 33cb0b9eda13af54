"""waifu2x upconv_7 / vgg_7, the original waifu2x CNNs, NHWC (counterpart
of ``nunif_tpu/waifu2x/models/upconv_7.py``).

Every conv is VALID, so a tile shrinks by the offset: upconv_7 is scale 2
with offset 14, vgg_7 scale 1 with offset 7.  Layer names give the flax
paths ``Conv_0`` .. ``Conv_5`` and ``ConvTranspose2dTorch_0`` (upconv_7) or
``Conv_6`` (vgg_7), so ``.nztm`` files pass between the two packages.
"""
from __future__ import annotations

from torch import nn

from ...models import I2IBaseModel, register_model
from ...modules.conv import ConvTranspose2dTorch, conv2d, leaky_relu


class _VGGStack(I2IBaseModel):
    widths = ()
    i2i_blend_size = 0
    i2i_default_tile_size = 256
    i2i_default_batch_size = 16

    def __init__(self, in_channels: int = 3, out_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        cin = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, w, 3))
            cin = w

    def trunk(self, x):
        """NCHW view in, NCHW out: the leaky-ReLU conv stack."""
        for i in range(len(self.widths)):
            x = leaky_relu(conv2d(x, getattr(self, f"Conv_{i}")), 0.1)
        return x


@register_model
class UpConv7(_VGGStack):
    model_name = "waifu2x.upconv_7"
    widths = (16, 32, 64, 128, 128, 256)
    i2i_scale = 2
    i2i_offset = 14

    def __init__(self, in_channels: int = 3, out_channels: int = 3):
        super().__init__(in_channels, out_channels)
        self.ConvTranspose2dTorch_0 = ConvTranspose2dTorch(
            self.widths[-1], out_channels, 4, stride=2, padding=3)

    def forward(self, x, train: bool = False):
        y = self.ConvTranspose2dTorch_0(self.trunk(x.permute(0, 3, 1, 2)))
        y = y.permute(0, 2, 3, 1)
        return y if train else y.clamp(0.0, 1.0)


@register_model
class VGG7(_VGGStack):
    model_name = "waifu2x.vgg_7"
    widths = (32, 32, 64, 64, 128, 128)
    i2i_scale = 1
    i2i_offset = 7

    def __init__(self, in_channels: int = 3, out_channels: int = 3):
        super().__init__(in_channels, out_channels)
        self.Conv_6 = nn.Conv2d(self.widths[-1], out_channels, 3)

    def forward(self, x, train: bool = False):
        y = conv2d(self.trunk(x.permute(0, 3, 1, 2)), self.Conv_6)
        y = y.permute(0, 2, 3, 1)
        return y if train else y.clamp(0.0, 1.0)
