"""waifu2x hub API (counterpart of ``nunif_tpu/waifu2x/hub.py`` and of the
root ``hubconf.py``'s three functions).

``waifu2x(model_type=..., method=..., noise_level=...)`` returns a
``Waifu2xImageModel`` whose ``convert`` takes a PIL image or an (H, W, C)
float array and returns the same kind.  Checkpoints come from
``<model root>/<model_type with "/" as "_">/`` (the model root is
``$NUNIF_TPU_MODEL_DIR``, else ``~/.cache/nunif_tpu/waifu2x``, the layout
the JAX package reads) or from ``model_dir``.  Where the model root has
no directory for the type, the bundled turbo zoo serves it, as in the JAX
package, but the port logs a warning that names the type asked for and
the checkpoints served (the JAX package falls back silently).  Runs on the
card unless ``device`` names another.

    from nunif_tpu_torch.waifu2x.hub import waifu2x
    model = waifu2x(model_type="turbo", method="scale")
    out = model.convert(pil_image)
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from ..utils import pil_io
from .runtime import CHECKPOINT_EXT, Waifu2x, default_model_dir

logger = logging.getLogger("nunif_tpu_torch.waifu2x")

MODEL_TYPES = ("art", "art_scan", "photo", "cunet/art", "swin_unet/art",
               "swin_unet/photo", "upconv_7/art", "upconv_7/photo",
               "turbo")  # "turbo": the bundled zoo


def default_model_root() -> str:
    return os.environ.get(
        "NUNIF_TPU_MODEL_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "nunif_tpu", "waifu2x"))


class Waifu2xImageModel:
    """PIL-facing wrapper of the ``Waifu2x`` runtime."""

    def __init__(self, model_type: str = "art", model_dir: Optional[str] = None,
                 tile_size=None, batch_size=None, tta=False,
                 keep_alpha=True, method: str = "scale",
                 noise_level: Optional[int] = None, device="cuda"):
        self.model_type = model_type
        self.method = method
        self.noise_level = noise_level
        self.model_dir = model_dir or os.path.join(
            default_model_root(), model_type.replace("/", "_"))
        if model_dir is None and not os.path.isdir(self.model_dir):
            bundled = default_model_dir()
            if bundled is not None:
                if model_type != "turbo":
                    served = sorted(f[:-len(CHECKPOINT_EXT)]
                                    for f in os.listdir(bundled)
                                    if f.endswith(CHECKPOINT_EXT))
                    logger.warning(
                        "waifu2x hub: no models for model_type %r (%s does "
                        "not exist); serving the bundled turbo_2x models "
                        "%s from %s instead", model_type, self.model_dir,
                        served, bundled)
                self.model_dir = bundled
        self.tile_size = tile_size
        self.batch_size = batch_size
        self.tta = tta
        self.keep_alpha = keep_alpha
        self.w2x = Waifu2x(self.model_dir, device=device)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def convert(self, im, method: Optional[str] = None,
                noise_level: Optional[int] = None):
        """im: PIL.Image or (H, W, C) float array in [0, 1] -> the same
        kind (a PIL image quantised as the CLI writes its PNGs)."""
        method = method or self.method
        noise_level = self.noise_level if noise_level is None else noise_level
        from PIL import Image
        is_pil = isinstance(im, Image.Image)
        if is_pil:
            src = im
            if src.mode not in ("RGB", "RGBA"):
                src = src.convert("RGBA" if "A" in src.mode else "RGB")
            x = np.asarray(src, np.float32) / 255.0
        else:
            x = np.asarray(im, np.float32)
        alpha = None
        if x.shape[-1] == 4:
            alpha = x[..., 3:4] if self.keep_alpha else None
            x = x[..., :3]
        rgb, out_alpha = self.w2x.convert(
            x, alpha, method=method, noise_level=noise_level,
            tile_size=self.tile_size, batch_size=self.batch_size, tta=self.tta)
        rgb = rgb.cpu().numpy()
        if out_alpha is not None:
            rgb = np.concatenate([rgb, out_alpha.cpu().numpy()], axis=-1)
        if is_pil:
            return Image.fromarray(pil_io.quantize(rgb, 8))
        return rgb

    def scale(self, im):
        return self.convert(im, method="scale")

    def denoise(self, im, noise_level: int = 1):
        return self.convert(im, method="noise", noise_level=noise_level)

    def scale_denoise(self, im, noise_level: int = 1):
        return self.convert(im, method="noise_scale", noise_level=noise_level)


def waifu2x(model_type: str = "art", model_dir: Optional[str] = None,
            tile_size=None, batch_size=None, tta=False, keep_alpha=True,
            method: str = "scale", noise_level: Optional[int] = None,
            device="cuda", **kwargs) -> Waifu2xImageModel:
    """The hub entry point (``hubconf.waifu2x``)."""
    return Waifu2xImageModel(model_type=model_type, model_dir=model_dir,
                             tile_size=tile_size, batch_size=batch_size,
                             tta=tta, keep_alpha=keep_alpha, method=method,
                             noise_level=noise_level, device=device)


def superresolution(model_type: str = "art", **kwargs):
    """2x upscale (``hubconf.superresolution``)."""
    return waifu2x(model_type=model_type, method="scale", **kwargs)


def denoise(model_type: str = "art", noise_level: int = 1, **kwargs):
    """Noise removal (``hubconf.denoise``)."""
    return waifu2x(model_type=model_type, method="noise",
                   noise_level=noise_level, **kwargs)
