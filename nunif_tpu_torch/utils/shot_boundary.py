"""Shot-boundary (scene cut) detection (counterpart of
``nunif_tpu/utils/shot_boundary.py``).

Frames are cut to 27 x 48 on the host.  With a TransNetV2 checkpoint
(``aux.transnetv2``) the net scores overlapping windows of 100 frames on
the device and keeps each window's middle 50; without one, a colour
histogram detector scores 1 - the cosine similarity of consecutive frames'
512-bin RGB histograms (host numpy).  A boundary is a frame whose score
reaches the threshold at least ``min_frames`` after the last one.

Unlike the JAX detector, which takes ``max_fps`` and never uses it, the
frames are retimed as ``video.process_video`` retimes them (the source's
rate capped at ``max_fps``), so a boundary indexes the frames the
processor counts, also for sources above ``max_fps``.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger("nunif_tpu_torch.utils")

TN_H, TN_W = 27, 48
WINDOW = 100
PAD = 25  # each 100-frame window scores its middle 50


def _resize_small(frame_u8: np.ndarray) -> np.ndarray:
    """Nearest-row / column cut to 27 x 48."""
    h, w = frame_u8.shape[:2]
    ys = (np.arange(TN_H) * h // TN_H).clip(0, h - 1)
    xs = (np.arange(TN_W) * w // TN_W).clip(0, w - 1)
    return frame_u8[ys][:, xs]


def _hist_diff_scores(small_frames: np.ndarray) -> np.ndarray:
    """1 - cosine similarity of consecutive frames' 512-bin RGB histograms."""
    f = small_frames.astype(np.int32)
    bins = ((f[..., 0] >> 5) << 6) + ((f[..., 1] >> 5) << 3) + (f[..., 2] >> 5)
    T = bins.shape[0]
    hists = np.zeros((T, 512), np.float32)
    flat = bins.reshape(T, -1)
    for t in range(T):
        np.add.at(hists[t], flat[t], 1.0)
    hists /= np.linalg.norm(hists, axis=1, keepdims=True) + 1e-12
    sim = np.sum(hists[1:] * hists[:-1], axis=1)
    return np.concatenate([[0.0], 1.0 - sim])


@torch.no_grad()
def _transnet_scores(small_frames: np.ndarray, model) -> np.ndarray:
    """Per-frame sigmoid of TransNetV2's one-hot logit, averaged over the
    windows' middles."""
    device = next(model.parameters()).device
    T = len(small_frames)
    scores = np.zeros(T, np.float32)
    counts = np.zeros(T, np.float32)
    step = WINDOW - 2 * PAD
    for start in range(0, max(T - PAD, 1), step):
        end = min(start + WINDOW, T)
        win = small_frames[start:end]
        if len(win) < WINDOW:
            win = np.concatenate([win, np.repeat(win[-1:], WINDOW - len(win), axis=0)])
        one_hot, _ = model(torch.from_numpy(win).to(device)[None].float())
        s = torch.sigmoid(one_hot[0, :, 0]).cpu().numpy()
        lo = PAD if start > 0 else 0
        hi = min(WINDOW, end - start)
        scores[start + lo:start + hi] += s[lo:hi]
        counts[start + lo:start + hi] += 1
        if end >= T:
            break
    return scores / np.maximum(counts, 1)


def read_small_frames(video_path: str, max_fps: float = 1e9) -> np.ndarray:
    """The video's frames, retimed as ``process_video`` retimes them, cut
    to 27 x 48: (T, 27, 48, 3) uint8."""
    from ..video import backend
    from ..video.engine import FixedFPSRetimer, guess_fps
    small = []
    with backend.VideoReader(video_path) as reader:
        retimer = FixedFPSRetimer(guess_fps(reader, max_fps))
        for frame, pts in reader:
            small.extend(_resize_small(f) for f in retimer(frame, pts))
        small.extend(_resize_small(f) for f in retimer.flush())
    return np.stack(small) if small else np.zeros((0, TN_H, TN_W, 3), np.uint8)


def boundaries_from_scores(scores, threshold: float, min_frames: int) -> list:
    boundaries = []
    last = -min_frames
    for t in range(1, len(scores)):
        if scores[t] >= threshold and t - last >= min_frames:
            boundaries.append(t)
            last = t
    return boundaries


def detect_boundaries(video_path: str, threshold: float = 0.4,
                      min_frames: int = 10, checkpoint: str = None,
                      max_fps: float = 1e9, device="cuda") -> list:
    """Sorted frame indexes where a new shot begins: TransNetV2 from
    ``checkpoint`` on ``device``, else the histogram detector."""
    small = read_small_frames(video_path, max_fps)
    if not len(small):
        return []
    if checkpoint:
        from ..models import load_model
        model, _meta = load_model(checkpoint, device=device)
        scores = _transnet_scores(small, model)
    else:
        logger.debug("shot_boundary: histogram detector (no checkpoint)")
        scores = _hist_diff_scores(small)
    return boundaries_from_scores(scores, threshold, min_frames)
