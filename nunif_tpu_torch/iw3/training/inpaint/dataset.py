"""Inpaint training data: image pairs with disocclusion-style hole masks
(counterpart of ``nunif_tpu/iw3/training/inpaint/dataset.py``).

A sample is (target, mask); the trainer masks the image itself.  Masks
imitate stereo-warp disocclusions (thin vertical streaks) plus random
blobs; the video dataset yields 12-frame clips of sliding crops with a
mask that slides with them.  Host numpy: given the same seed and files it
gives the same arrays as the JAX dataset.  Images come from a directory,
or are synthesized (waifu2x's generators) when it holds none.
"""
from __future__ import annotations

import os

import numpy as np

from ....utils.image_loader import list_images


def _load_or_synth(files, rng, size):
    if files:
        from PIL import Image
        f = files[rng.integers(0, len(files))]
        with Image.open(f) as im:
            im = im.convert("RGB")
            arr = np.asarray(im, np.float32) / 255.0
        if arr.shape[0] < size + 1 or arr.shape[1] < size + 1:
            pad_h = max(0, size + 1 - arr.shape[0])
            pad_w = max(0, size + 1 - arr.shape[1])
            arr = np.pad(arr, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
        return arr
    from ....waifu2x.training.generators import gen_random
    im = gen_random(size * 2, seed=int(rng.integers(0, 2 ** 31)))
    return np.asarray(im.convert("RGB"), np.float32) / 255.0


def make_hole_mask(rng, size, n_streaks=(2, 6), n_blobs=(0, 3)):
    """Disocclusion-like mask: vertical streaks of varying width + blobs."""
    mask = np.zeros((size, size, 1), np.float32)
    for _ in range(rng.integers(*n_streaks)):
        w = int(rng.integers(1, max(2, size // 16)))
        x0 = int(rng.integers(0, size - w))
        y0 = int(rng.integers(0, size // 2))
        y1 = int(rng.integers(y0 + size // 4, size + 1))
        mask[y0:y1, x0:x0 + w] = 1.0
    for _ in range(rng.integers(*n_blobs) if n_blobs[1] > n_blobs[0] else 0):
        h = int(rng.integers(size // 16, size // 4))
        w = int(rng.integers(size // 16, size // 4))
        y0 = int(rng.integers(0, size - h))
        x0 = int(rng.integers(0, size - w))
        mask[y0:y0 + h, x0:x0 + w] = 1.0
    return mask


class InpaintDataset:
    """Single-frame samples (reference dataset.py)."""

    def __init__(self, input_dir, size=128, num_samples=2000, seed=71,
                 training=True):
        self.files = (list_images(input_dir)
                      if input_dir and os.path.isdir(input_dir) else [])
        self.size = size
        self.num_samples = num_samples
        self.seed = seed
        self.training = training

    def __len__(self):
        return self.num_samples

    def sample(self, rng):
        s = self.size
        arr = _load_or_synth(self.files, rng, s)
        top = int(rng.integers(0, arr.shape[0] - s + 1))
        left = int(rng.integers(0, arr.shape[1] - s + 1))
        y = arr[top:top + s, left:left + s]
        mask = make_hole_mask(rng, s)
        return y, mask

    def batches(self, batch_size):
        rng = np.random.default_rng(self.seed)
        for i in range(0, self.num_samples, batch_size):
            ys, masks = [], []
            for _ in range(batch_size):
                y, m = self.sample(rng)
                ys.append(y)
                masks.append(m)
            yield {"y": np.stack(ys), "mask": np.stack(masks)}


class VideoInpaintDataset:
    """SEQ_LEN-frame clips via sliding crops (reference dataset_video.py);
    each batch is one clip."""

    def __init__(self, input_dir, size=128, num_samples=200, seq_len=12,
                 seed=71, training=True):
        self.files = (list_images(input_dir)
                      if input_dir and os.path.isdir(input_dir) else [])
        self.size = size
        self.seq_len = seq_len
        self.num_samples = num_samples
        self.seed = seed
        self.training = training

    def __len__(self):
        return self.num_samples

    def sample(self, rng):
        s = self.size
        arr = _load_or_synth(self.files, rng, s + self.seq_len * 2)
        H, W = arr.shape[:2]
        dy = int(rng.integers(-2, 3))
        dx = int(rng.integers(-2, 3))
        max_shift = max(abs(dy), abs(dx)) * self.seq_len
        top = int(rng.integers(max_shift, max(H - s - max_shift, max_shift) + 1))
        left = int(rng.integers(max_shift, max(W - s - max_shift, max_shift) + 1))
        ys, masks = [], []
        base_mask = make_hole_mask(rng, s)
        for t in range(self.seq_len):
            yy = np.clip(top + dy * t, 0, H - s)
            xx = np.clip(left + dx * t, 0, W - s)
            ys.append(arr[yy:yy + s, xx:xx + s])
            masks.append(np.roll(base_mask, shift=dx * t, axis=1))
        return np.stack(ys), np.stack(masks)

    def batches(self, batch_size=None):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_samples):
            y, m = self.sample(rng)
            yield {"y": y, "mask": m}
