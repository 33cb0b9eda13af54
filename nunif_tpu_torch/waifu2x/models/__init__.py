from .swin_unet import (SwinUNet, SwinUNet2x, SwinUNet4x, SwinUNet8x,
                        SwinUNetDownscaled, swin_unet_4xl)
from .turbo import Turbo2x, Turbo4x
from .upconv_7 import UpConv7, VGG7

__all__ = ["SwinUNet", "SwinUNet2x", "SwinUNet4x", "SwinUNet8x",
           "SwinUNetDownscaled", "swin_unet_4xl", "Turbo2x", "Turbo4x",
           "UpConv7", "VGG7"]
