"""Letterbox / black-bar detection on the host, numpy only (counterpart
of ``AutoCropDetector`` in ``nunif_tpu/utils/autocrop.py``, a copy: the
port imports nothing of the JAX package).

Modes: ``black`` (dark and flat rows and columns, on tv-range luma),
``flat`` (rows and columns within 16 / 255 of their median at 99% of
their pixels), each also for top / bottom (``_tb``) or left / right
(``_lr``) only.  ``autocrop_analyze_video`` samples a video file.
"""
from __future__ import annotations

import numpy as np

MODES = ("black", "black_tb", "black_lr", "flat", "flat_tb", "flat_lr")


def _rgb_to_y(x: np.ndarray, tv_range: bool) -> np.ndarray:
    # x: HWC [0,1]
    y = x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
    if tv_range:
        y = np.clip(y, 16.0 / 255.0, 235.0 / 255.0)
    return y


def _detect_axis(y: np.ndarray, axis: int, black_only: bool) -> np.ndarray:
    """Per-row (axis=1 reduces cols) or per-col bar mask."""
    if black_only:
        mean = y.mean(axis=axis, keepdims=True)
        is_dark = mean <= 32.0 / 255.0
        is_flat = np.abs(y - mean).max(axis=axis, keepdims=True) < 16.0 / 255.0
        return (is_dark & is_flat).squeeze(axis)
    median = np.median(y, axis=axis, keepdims=True)
    within = (np.abs(y - median) < 16.0 / 255.0).mean(axis=axis, keepdims=True)
    return (within > 0.99).squeeze(axis)


def _mask_to_slice(mask: np.ndarray) -> slice:
    non_border = np.nonzero(~mask)[0]
    if len(non_border) in (0, len(mask)):
        return slice(None, None)
    start = int(non_border[0])
    stop = int(non_border[-1]) + 1
    return slice(start if start > 0 else None,
                 stop if stop < len(mask) else None)


def _apply_mod(s: slice, mod: int) -> slice:
    start, stop = s.start, s.stop
    if start is not None and start % mod != 0:
        start = start + (mod - start % mod)
    if stop is not None and stop % mod != 0:
        stop = stop - stop % mod
    return slice(start, stop)


class AutoCropDetector:
    """Letterbox detection over one or more frames: ``update`` counts, per
    row and column, the frames where it is a bar; ``get_crop`` crops the
    outer rows / columns that are bars in at least
    ``frame_variation_threshold`` of the frames, as slices aligned to
    ``mod``.  Frames are HWC (or NHWC) floats in [0, 1]."""

    def __init__(self, mode: str = "black", mod: int = 2,
                 frame_variation_threshold: float = 0.95):
        if mode not in MODES:
            raise ValueError(f"autocrop mode {mode!r} not in {MODES}")
        self.mode = mode
        self.mod = mod
        self.frame_variation_threshold = frame_variation_threshold
        self.black_only = mode.startswith("black")
        self.reset()

    def reset(self):
        self.border_count_tb = None
        self.border_count_lr = None
        self.frame_count = 0

    def update(self, frame: np.ndarray):
        """frame: HWC [0,1] or NHWC batch."""
        if frame.ndim == 4:
            for f in frame:
                self.update(f)
            return
        y = _rgb_to_y(frame, tv_range=self.black_only)
        if self.mode in {"black_tb", "black", "flat_tb", "flat"}:
            m = _detect_axis(y, 1, self.black_only)
            self.border_count_tb = (m.astype(np.int64)
                                    if self.border_count_tb is None
                                    else self.border_count_tb + m)
        if self.mode in {"black_lr", "black", "flat_lr", "flat"}:
            m = _detect_axis(y, 0, self.black_only)
            self.border_count_lr = (m.astype(np.int64)
                                    if self.border_count_lr is None
                                    else self.border_count_lr + m)
        self.frame_count += 1

    def get_crop(self, frame_variation_threshold=None):
        """Returns (slice_tb, slice_lr)."""
        t = frame_variation_threshold or self.frame_variation_threshold
        if self.frame_count == 0:
            return slice(None), slice(None)
        slice_tb = slice(None)
        slice_lr = slice(None)
        if self.border_count_tb is not None:
            slice_tb = _apply_mod(_mask_to_slice(
                self.border_count_tb / self.frame_count >= t), self.mod)
        if self.border_count_lr is not None:
            slice_lr = _apply_mod(_mask_to_slice(
                self.border_count_lr / self.frame_count >= t), self.mod)
        return slice_tb, slice_lr

    @classmethod
    def detect(cls, frame: np.ndarray, mode: str = "black", mod: int = 2):
        d = cls(mode=mode, mod=mod)
        d.update(frame)
        return d.get_crop(frame_variation_threshold=0.5)


def autocrop_analyze_video(video_path: str, mode="black", mod=2,
                           max_frames=40):
    """(slice_tb, slice_lr) of a video: about ``max_frames`` frames sampled
    evenly through ``AutoCropDetector``."""
    from ..video import backend
    det = AutoCropDetector(mode=mode, mod=mod)
    with backend.VideoReader(video_path) as reader:
        n = reader.nb_frames or 0
        stride = max(1, int(n // max_frames)) if n else 1
        for i, (frame, _pts) in enumerate(reader):
            if i % stride == 0:
                det.update(frame.astype(np.float32) / 255.0)
    return det.get_crop()
