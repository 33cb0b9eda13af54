"""Image listing (counterpart of ``nunif_tpu/utils/image_loader.py``:
``list_images``, which the inpaint dataset reads its directory with; the
JAX module's prefetching ``ImageLoader`` has no caller in the port)."""
from __future__ import annotations

import os

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tif", ".tiff")


def list_images(directory):
    """The image files of ``directory`` (by extension), sorted by name."""
    return [os.path.join(directory, name) for name in sorted(os.listdir(directory))
            if os.path.splitext(name)[-1].lower() in IMG_EXTENSIONS]
