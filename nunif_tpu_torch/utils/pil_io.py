"""Image I/O through PIL (counterpart of ``nunif_tpu/utils/pil_io.py``).

Loads to float32 HWC numpy in [0, 1] (RGB, or gray with ``color="gray"``),
keeping alpha as a last channel, reading 16-bit PNGs, converting an ICC
profile to sRGB and applying EXIF rotation; writes 8-bit images through
PIL and 16-bit PNGs.  PIL writes 16 bits for one channel only, so a 16-bit
PNG with colour or alpha is written here (``encode_png``: zlib and
struct, filter 0 on every row); one gray channel keeps PIL's ``I;16``.
PIL is imported at call time, so the package imports where PIL is absent
(``encode_png`` needs none).

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
import struct
import zlib
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


def load_image(path_or_file, color: str = "rgb") -> Tuple[np.ndarray, ImageMeta]:
    """(HWC float32 in [0, 1], meta), EXIF-rotated, alpha kept as the last
    channel: (H, W, 3) or (H, W, 4) for ``color="rgb"``; (H, W, 1) or (H,
    W, 2) for ``color="gray"`` (ITU-R 601 luma of the sRGB pixels, as the
    JAX package reads gray).  16-bit grayscale is spread to three channels
    for ``"rgb"``."""
    from PIL import Image, ImageOps
    if color not in ("rgb", "gray"):
        raise ValueError(f"color must be 'rgb' or 'gray', not {color!r}")
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
            arr = np.clip(np.asarray(im, dtype=np.float32) / 65535.0, 0.0, 1.0)
            return (np.stack([arr] * 3, axis=-1) if color == "rgb"
                    else arr[..., None]), meta
        has_alpha = im.mode in ("RGBA", "LA", "PA") or "transparency" in im.info
        im, meta.srgb = _to_srgb(im.convert("RGBA" if has_alpha else "RGB"))
        if color == "gray" and not has_alpha:
            return np.asarray(im.convert("L"), dtype=np.float32)[..., None] \
                / 255.0, meta
        arr = np.asarray(im, dtype=np.float32) / 255.0
        if color == "gray":
            luma = arr[..., :3] @ np.array([0.299, 0.587, 0.114], np.float32)
            arr = np.concatenate([luma[..., None], arr[..., 3:4]], axis=-1)
        return arr, meta


def to_pil(x: np.ndarray, bit_depth: int = 8):
    """(H, W, 1 to 4) float in [0, 1] -> 8-bit L, LA, RGB or RGBA PIL
    image; one channel at ``bit_depth`` 16 -> ``I;16``."""
    from PIL import Image
    x = np.clip(np.asarray(x), 0.0, 1.0)
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if bit_depth == 16 and x.ndim == 2:
        return Image.fromarray(quantize(x, 16))
    return Image.fromarray(quantize(x, 8))


def quantize(x: np.ndarray, bit_depth: int) -> np.ndarray:
    """x in [0, 1] to uint8 or uint16 samples, rounded half up."""
    top, dtype = {8: (255.0, np.uint8), 16: (65535.0, np.uint16)}[bit_depth]
    return np.floor(np.clip(np.asarray(x, np.float32), 0.0, 1.0) * top
                    + 0.5).astype(dtype)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(x: np.ndarray, icc_profile: Optional[bytes] = None) -> bytes:
    """16-bit PNG bytes of x (H, W, 1 to 4) float in [0, 1]: colour type
    0, 4, 2 or 6 by the channel count, big-endian samples, no interlace,
    filter 0 on every row; ``icc_profile`` goes in an iCCP chunk."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = x[..., None]
    h, w, c = x.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = quantize(x, 16).astype(">u2").reshape(h, w * c).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    out = [b"\x89PNG\r\n\x1a\n",
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, color_type,
                                           0, 0, 0))]
    if icc_profile:
        out.append(_png_chunk(b"iCCP", b"ICC Profile\x00\x00"
                              + zlib.compress(icc_profile)))
    out.append(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def _format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    return {".jpg": "JPEG", ".jpeg": "JPEG", ".webp": "WEBP", ".bmp": "BMP",
            ".tif": "TIFF", ".tiff": "TIFF"}.get(ext, "PNG")


def save_image(x: np.ndarray, path: str, meta: Optional[ImageMeta] = None,
               bit_depth: int = 8, **kwargs):
    """Write x (HWC float in [0, 1], 1 to 4 channels) in the format of
    ``path``'s extension, with the source's ICC profile where the pixels
    are still in it (none after ``load_image`` converted them to sRGB);
    ``bit_depth`` 16 writes a 16-bit PNG (other formats stay 8-bit);
    ``kwargs`` go to PIL (quality)."""
    x = np.asarray(x)
    icc = meta.icc_profile if meta and meta.icc_profile and not meta.srgb \
        else None
    fmt = _format(path)
    tmp = path + ".tmp"
    if bit_depth == 16 and fmt == "PNG" and x.ndim == 3 and x.shape[-1] > 1:
        with open(tmp, "wb") as f:
            f.write(encode_png(x, icc))
        os.replace(tmp, path)
        return
    im = to_pil(x, bit_depth if fmt == "PNG" else 8)
    params = dict(kwargs)
    if icc:
        params.setdefault("icc_profile", icc)
    if fmt == "JPEG" and im.mode in ("RGBA", "LA"):
        im = im.convert(im.mode[:-1])
    im.save(tmp, format=fmt, **params)
    os.replace(tmp, path)
