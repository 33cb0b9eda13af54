"""The stabilizer's analysis cache (counterpart of
``nunif_tpu/stlizer/cache.py``): passes 1-2 of a video in an ``.npz``
named by the md5 of its path and size, the JAX package's format, so
either package reads the other's."""
from __future__ import annotations

import hashlib
import os

import numpy as np

CACHE_VERSION = 1
KEYS = ("shift_x", "shift_y", "angle", "scene_weight", "fps", "resize_scale",
        "center")


def filepath_md5(filepath: str) -> str:
    size = os.path.getsize(filepath)
    return hashlib.md5(f"{filepath}_{size}".encode()).hexdigest()


def cache_path(input_video_path: str, cache_dir: str) -> str:
    return os.path.join(cache_dir, filepath_md5(input_video_path) + ".stlizer.npz")


def save_cache(input_video_path: str, cache_dir: str, *, shift_x, shift_y,
               angle, scene_weight, fps, resize_scale, center):
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache_path(input_video_path, cache_dir),
             version=CACHE_VERSION,
             shift_x=np.asarray(shift_x), shift_y=np.asarray(shift_y),
             angle=np.asarray(angle), scene_weight=np.asarray(scene_weight),
             fps=float(fps), resize_scale=float(resize_scale),
             center=np.asarray(center))


def load_cache(input_video_path: str, cache_dir: str):
    try:
        p = cache_path(input_video_path, cache_dir)
    except OSError:
        return None
    if not os.path.exists(p):
        return None
    with np.load(p) as data:
        if int(data["version"]) != CACHE_VERSION:
            return None
        return {k: data[k] for k in KEYS}
