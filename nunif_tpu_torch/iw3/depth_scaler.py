"""EMA min-max depth normalisation with a lookahead buffer (counterpart of
``nunif_tpu/iw3/depth_scaler.py``).

Per-frame min and max are reduced on the device and read back once a
batch; the ring-buffer state machine is host Python, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def minmax_normalize(frame, min_value, max_value):
    """(frame - min) / (max - min) clipped to [0, 1]; a flat range
    (max <= min) gives clip(frame, 0, 1) instead of a division by zero."""
    min_value, max_value = _as(min_value, frame), _as(max_value, frame)
    scale = max_value - min_value
    normalized = ((frame - min_value) / scale.clamp(min=1e-38)).clamp(0.0, 1.0)
    return torch.where(scale > 0, normalized, frame.clamp(0.0, 1.0))


def max_normalize(frame, min_value, max_value):
    """frame / max clipped to [0, 1] (the minimum is not used); a max <= 0
    gives clip(frame, 0, 1)."""
    max_value = _as(max_value, frame)
    normalized = (frame / max_value.clamp(min=1e-38)).clamp(0.0, 1.0)
    return torch.where(max_value > 0, normalized, frame.clamp(0.0, 1.0))


NORMALIZERS = {"minmax": minmax_normalize, "max": max_normalize}


def frame_stats(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) -> (B, 2) per-frame [min, max]."""
    flat = frames.reshape(frames.shape[0], -1)
    return torch.stack([flat.amin(dim=1), flat.amax(dim=1)], dim=-1)


class MinMaxBuffer:
    """Interleaved (min, max) ring buffer."""

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("buffer size must be positive")
        self.count = 0
        self.size = size * 2
        self.data = np.zeros(self.size, dtype=np.float64)

    def add(self, min_value, max_value):
        if self.count == 0:
            self.data[0::2] = float(min_value)
            self.data[1::2] = float(max_value)
            self.count = 2
        else:
            self.data[self.count % self.size] = float(min_value)
            self.count += 1
            self.data[self.count % self.size] = float(max_value)
            self.count += 1

    def is_filled(self) -> bool:
        return self.count >= self.size

    def get_minmax(self):
        return float(self.data.min()), float(self.data.max())


class EMAMinMaxScaler:
    """decay 0 / buffer 1 is per-frame min-max; decay > 0 smooths the range
    over frames; buffer > 1 looks ahead that many frames.  ``mode``
    "minmax" maps [min, max] to [0, 1], "max" divides by the max only
    (Depth-Anything-V3 mono)."""

    def __init__(self, decay=0.0, buffer_size=1, mode="minmax"):
        if buffer_size <= 0:
            raise ValueError("buffer_size must be positive")
        if mode not in NORMALIZERS:
            raise ValueError(f"unknown scaler mode {mode!r}")
        self.mode = mode
        self.normalize = NORMALIZERS[mode]
        self.frame_queue = []
        self.reset(decay=decay, buffer_size=buffer_size)

    def reset(self, decay=None, buffer_size=None, **kwargs):
        if decay is not None:
            self.decay = float(decay)
        if buffer_size is not None:
            self.buffer_size = int(buffer_size)
        self.min_value = None
        self.max_value = None
        self.frame_queue = []
        self.minmax_buffer = None

    def get_minmax(self):
        return self.minmax_buffer.get_minmax()

    def _advance(self, min_value, max_value):
        if self.min_value is None:
            self.min_value, self.max_value = min_value, max_value
        else:
            self.min_value = self.decay * self.min_value + (1 - self.decay) * min_value
            self.max_value = self.decay * self.max_value + (1 - self.decay) * max_value

    def update_values(self, mm, reset_flags=None):
        """Advance the EMA on host scalars only: mm (B, 2) numpy [min, max]
        rows -> (B, 2) float64 normalisation constants.  Needs
        buffer_size 1.  reset_flags[i] clears the state after frame i."""
        if self.buffer_size != 1:
            raise ValueError("update_values needs buffer_size == 1")
        out = np.empty(mm.shape, dtype=np.float64)
        for i in range(mm.shape[0]):
            self._advance(float(mm[i, 0]), float(mm[i, 1]))
            out[i] = (self.min_value, self.max_value)
            if reset_flags is not None and reset_flags[i]:
                self.min_value = self.max_value = None
        return out

    def update_batch(self, frames, reset_flags=None, return_minmax=False):
        """(B, H, W, 1) frames with one device-to-host read; returns the
        frames that are ready (all of them with buffer 1), normalised."""
        B = frames.shape[0]
        reset_flags = reset_flags or [False] * B
        mm = frame_stats(frames).cpu().double().numpy()
        ready, consts = [], []
        for i in range(B):
            if self.minmax_buffer is None:
                self.minmax_buffer = MinMaxBuffer(self.buffer_size)
            self.frame_queue.append(frames[i])
            self.minmax_buffer.add(mm[i, 0], mm[i, 1])
            if self.minmax_buffer.is_filled():
                self._advance(*self.get_minmax())
                ready.append(self.frame_queue.pop(0))
                consts.append((self.min_value, self.max_value))
            if reset_flags[i]:
                if self.frame_queue:
                    if self.min_value is None:
                        mn, mx = self.minmax_buffer.get_minmax()
                    else:
                        mn, mx = self.min_value, self.max_value
                    for f in self.frame_queue:
                        ready.append(f)
                        consts.append((mn, mx))
                self.reset()
        if not ready:
            return []
        stacked = torch.stack(ready)
        c = torch.tensor(consts, dtype=torch.float32, device=stacked.device)
        normalized = self.normalize(stacked, c[:, 0].reshape(-1, 1, 1, 1),
                                    c[:, 1].reshape(-1, 1, 1, 1))
        if return_minmax:
            return [(normalized[i], consts[i][0], consts[i][1])
                    for i in range(len(ready))]
        return list(normalized)

    def flush(self, return_minmax=False):
        if not self.frame_queue:
            self.reset()
            return []
        if self.min_value is None:
            min_value, max_value = self.minmax_buffer.get_minmax()
        else:
            min_value, max_value = self.min_value, self.max_value
        frames = [self.normalize(f, min_value, max_value)
                  for f in self.frame_queue]
        if return_minmax:
            frames = [(f, min_value, max_value) for f in frames]
        self.reset()
        return frames
