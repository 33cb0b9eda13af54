from .swin_unet import (SwinUNet, SwinUNet2x, SwinUNet4x, SwinUNet8x,
                        SwinUNetDownscaled, swin_unet_4xl)

__all__ = ["SwinUNet", "SwinUNet2x", "SwinUNet4x", "SwinUNet8x",
           "SwinUNetDownscaled", "swin_unet_4xl"]
