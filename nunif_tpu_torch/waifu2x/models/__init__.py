from .swin_unet import (SwinUNet, SwinUNet2x, SwinUNet4x, SwinUNet8x,
                        SwinUNetDownscaled, swin_unet_4xl)
from .cunet import CUNet, UpCUNet
from .swin_unet_v2 import (SwinUNet1xV2, SwinUNet2xV2, SwinUNet4xV2,
                           SwinUNetV2Downscaled, swin_unet_v2_1xs)
from .wgmlp import WGMLP4x
from .turbo import Turbo2x, Turbo4x
from .upconv_7 import UpConv7, VGG7
from .discriminator import (L3Discriminator, V1Discriminator, L3V1Discriminator,
                            L3ConditionalDiscriminator,
                            V1ConditionalDiscriminator,
                            L3V1ConditionalDiscriminator,
                            U3ConditionalDiscriminator)

__all__ = ["SwinUNet", "SwinUNet2x", "SwinUNet4x", "SwinUNet8x",
           "SwinUNetDownscaled", "swin_unet_4xl", "CUNet", "UpCUNet",
           "SwinUNet1xV2", "SwinUNet2xV2", "SwinUNet4xV2",
           "SwinUNetV2Downscaled", "swin_unet_v2_1xs", "WGMLP4x",
           "Turbo2x", "Turbo4x", "UpConv7", "VGG7", "L3Discriminator",
           "V1Discriminator", "L3V1Discriminator", "L3ConditionalDiscriminator",
           "V1ConditionalDiscriminator", "L3V1ConditionalDiscriminator",
           "U3ConditionalDiscriminator"]
