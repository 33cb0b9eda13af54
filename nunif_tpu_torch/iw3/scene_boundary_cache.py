"""Scene-boundary cache (counterpart of ``nunif_tpu/iw3/scene_boundary_cache.py``).

Stores each video's scene-cut frame indexes, keyed on (max_fps, absolute
path, size, mtime), as JSON in the same directory and format as the JAX
package (``$NUNIF_TPU_HOME/iw3_scene_cache``, by default
``~/.cache/nunif_tpu/iw3_scene_cache``), so either package reads the
other's cache and the detection pass runs once a video.
"""
from __future__ import annotations

import hashlib
import json
import os


def _md5(s: str) -> str:
    return hashlib.md5((s + "iw3").encode()).hexdigest()


def default_cache_dir() -> str:
    root = os.environ.get("NUNIF_TPU_HOME", os.path.join(
        os.path.expanduser("~"), ".cache", "nunif_tpu"))
    d = os.path.join(root, "iw3_scene_cache")
    os.makedirs(d, exist_ok=True)
    return d


def get_cache_path(input_video_path: str, max_fps, cache_dir=None) -> str:
    cache_dir = cache_dir or default_cache_dir()
    st = os.stat(input_video_path)
    param = (f"{max_fps} {os.path.abspath(input_video_path)} "
             f"{st.st_size} {st.st_mtime}")
    return os.path.join(cache_dir, _md5(param) + ".json")


def save_cache(input_video_path: str, boundaries, max_fps, cache_dir=None):
    p = get_cache_path(input_video_path, max_fps, cache_dir)
    with open(p, "w", encoding="utf-8") as f:
        json.dump({"boundaries": sorted(int(b) for b in boundaries),
                   "max_fps": max_fps}, f)


def load_cache(input_video_path: str, max_fps, cache_dir=None):
    try:
        p = get_cache_path(input_video_path, max_fps, cache_dir)
    except OSError:
        return None
    if not os.path.exists(p):
        return None
    try:
        with open(p, encoding="utf-8") as f:
            return list(json.load(f)["boundaries"])
    except (json.JSONDecodeError, KeyError, OSError):
        return None


def detect_boundaries_cached(input_video_path: str, max_fps,
                             threshold: float = 0.3, min_frames: int = 10,
                             checkpoint=None, cache_dir=None, device="cuda"):
    cached = load_cache(input_video_path, max_fps, cache_dir)
    if cached is not None:
        return cached
    from ..utils.shot_boundary import detect_boundaries
    boundaries = detect_boundaries(input_video_path, threshold=threshold,
                                   min_frames=min_frames, checkpoint=checkpoint,
                                   max_fps=max_fps, device=device)
    save_cache(input_video_path, boundaries, max_fps, cache_dir)
    return boundaries
