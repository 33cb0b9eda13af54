from .swin_unet import SwinUNet2x

__all__ = ["SwinUNet2x"]
