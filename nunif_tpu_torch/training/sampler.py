"""Hard-example mining sampler (counterpart of
``nunif_tpu/training/sampler.py``, copied: host numpy).

Per-sample loss SMA updated each epoch; sampling weights reweighted by the
mining method.
"""
from __future__ import annotations

import enum

import numpy as np


class MiningMethod(enum.Enum):
    LINEAR = 0
    TOP10 = 1
    TOP20 = 2


class HardExampleSampler:
    def __init__(self, n_samples: int, losses=None, method=MiningMethod.LINEAR,
                 history_size: int = 4, scale_factor: float = 4.0, seed: int = 0):
        self.n = int(n_samples)
        self.method = method
        self.history_size = history_size
        self.scale_factor = scale_factor
        self.losses = np.zeros((self.n, history_size), np.float64)
        self.counts = np.zeros((self.n,), np.int64)
        self.weights = np.full((self.n,), 1.0 / self.n, np.float64)
        self.rng = np.random.default_rng(seed)
        if losses is not None:
            for i, v in enumerate(losses):
                self.update_loss(i, v)

    def update_loss(self, index, loss: float):
        i = self.counts[index] % self.history_size
        self.losses[index, i] = loss
        self.counts[index] += 1

    def update_losses(self, indexes, losses):
        for i, v in zip(np.asarray(indexes).ravel(), np.asarray(losses).ravel()):
            self.update_loss(int(i), float(v))

    def _sma(self):
        m = np.minimum(self.counts, self.history_size)
        m = np.maximum(m, 1)
        return self.losses.sum(axis=1) / m

    def update_weights(self):
        """Recompute sampling weights from loss SMA (reference :39-66)."""
        sma = self._sma()
        if self.method == MiningMethod.LINEAR:
            lo, hi = sma.min(), sma.max()
            span = (hi - lo) or 1.0
            w = 1.0 + (sma - lo) / span * (self.scale_factor - 1.0)
        else:
            q = 0.9 if self.method == MiningMethod.TOP10 else 0.8
            thresh = np.quantile(sma, q)
            w = np.where(sma >= thresh, self.scale_factor, 1.0)
        self.weights = w / w.sum()

    def sample(self, batch_size: int) -> np.ndarray:
        return self.rng.choice(self.n, size=batch_size, p=self.weights)

    def epoch_indexes(self) -> np.ndarray:
        """A full epoch of weighted-with-replacement indexes
        (torch WeightedRandomSampler semantics)."""
        return self.rng.choice(self.n, size=self.n, p=self.weights)
