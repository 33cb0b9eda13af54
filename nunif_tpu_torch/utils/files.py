"""File listing shared by the CLIs (the JAX package's
``waifu2x/training/dataset.py:listdir_images``)."""
import os

# the image suffixes the JAX package lists
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def listdir_images(d, exts=IMAGE_EXTS):
    """Image files under ``d``, recursively, sorted within each directory;
    a file counts when its lower-cased suffix is in ``exts``."""
    out = []
    for root, _dirs, files in os.walk(d):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in exts:
                out.append(os.path.join(root, f))
    return out
