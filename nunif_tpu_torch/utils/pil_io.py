"""Image I/O through PIL (counterpart of ``nunif_tpu/utils/pil_io.py``).

Loads to float32 HWC RGB numpy in [0, 1], keeping alpha as a 4th channel,
reading 16-bit PNGs, converting an ICC profile to sRGB and applying EXIF
rotation; writes 8-bit RGB(A).  PIL is imported at call time, so the
package imports where PIL is absent.

The reference (``nunif_tpu/utils/pil_io.py``) embeds the source's ICC
profile again in every saved image, also after it converted the pixels to
sRGB, so a colour-managed viewer applies the profile twice.  Here
``save_image`` embeds the source's profile only when the pixels are still
in it (``ImageMeta.srgb``: the conversion failed or did not apply), and
after a conversion embeds none, which viewers read as sRGB.
"""
from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np


class ImageMeta:
    """``srgb``: the loaded pixels were converted from ``icc_profile`` to
    sRGB, so that profile no longer describes them."""

    def __init__(self, mode=None, icc_profile=None, filename=None, srgb=False):
        self.mode = mode
        self.icc_profile = icc_profile
        self.filename = filename
        self.srgb = srgb


def _to_srgb(im):
    """(image in sRGB, whether it was converted); an image whose profile
    fails to convert comes back unchanged."""
    from PIL import ImageCms
    icc = im.info.get("icc_profile")
    if not icc:
        return im, False
    try:
        src = ImageCms.ImageCmsProfile(io.BytesIO(icc))
        dst = ImageCms.createProfile("sRGB")
        return ImageCms.profileToProfile(im, src, dst, outputMode=im.mode), True
    except (OSError, ValueError, ImageCms.PyCMSError):
        return im, False


def load_image(path_or_file) -> Tuple[np.ndarray, ImageMeta]:
    """(HWC float32 RGB in [0, 1], meta), EXIF-rotated; alpha kept as a 4th
    channel; 16-bit grayscale spread to three channels."""
    from PIL import Image, ImageOps
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path_or_file) as im:
        im.load()
        meta = ImageMeta(
            mode=im.mode, icc_profile=im.info.get("icc_profile"),
            filename=str(path_or_file)
            if isinstance(path_or_file, (str, os.PathLike))
            else getattr(path_or_file, "name", None))
        im = ImageOps.exif_transpose(im)
        if im.mode in ("I", "I;16", "I;16B", "I;16L"):
            arr = np.asarray(im, dtype=np.float32) / 65535.0
            return np.clip(np.stack([arr] * 3, axis=-1), 0.0, 1.0), meta
        has_alpha = im.mode in ("RGBA", "LA", "PA") or "transparency" in im.info
        im, meta.srgb = _to_srgb(im.convert("RGBA" if has_alpha else "RGB"))
        return np.asarray(im, dtype=np.float32) / 255.0, meta


def to_pil(x: np.ndarray):
    """(H, W, 3 or 4) float in [0, 1] -> 8-bit RGB(A) PIL image."""
    from PIL import Image
    return Image.fromarray(
        (np.clip(np.asarray(x), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))


def save_image(x: np.ndarray, path: str, meta: Optional[ImageMeta] = None,
               **kwargs):
    """Write x (HWC float in [0, 1]) in the format of ``path``'s extension,
    with the source's ICC profile where the pixels are still in it (none
    after ``load_image`` converted them to sRGB); ``kwargs`` go to PIL
    (quality)."""
    im = to_pil(x)
    params = dict(kwargs)
    if meta and meta.icc_profile and not meta.srgb:
        params.setdefault("icc_profile", meta.icc_profile)
    ext = os.path.splitext(path)[1].lower()
    fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".webp": "WEBP", ".bmp": "BMP",
           ".tif": "TIFF", ".tiff": "TIFF"}.get(ext, "PNG")
    if fmt == "JPEG" and im.mode == "RGBA":
        im = im.convert("RGB")
    tmp = path + ".tmp"
    im.save(tmp, format=fmt, **params)
    os.replace(tmp, path)
