"""cliqa patch extraction and predictors (counterpart of
``nunif_tpu/cliqa/utils.py``).

Patches are chosen on the host in float32 numpy with the JAX package's
scores and its ``np.argsort(...)[::-1]``, which is not a stable sort: the
same scores computed on the card could order ties otherwise, so the chosen
patches would differ.  Only the model runs on its device, in the dtype of
the patches (float32).
"""
from __future__ import annotations

import numpy as np
import torch

PATCH_SIZE = 128


def std_score(patches):
    """(N, P, P, C) -> each patch's mean over channels of its std."""
    return patches.std(axis=(1, 2)).mean(axis=-1)


def tv_score(patches):
    yg = np.abs(patches[:, 1:, :, :] - patches[:, :-1, :, :])
    xg = np.abs(patches[:, :, 1:, :] - patches[:, :, :-1, :])
    return (yg.mean(axis=(1, 2, 3)) + xg.mean(axis=(1, 2, 3))) * 0.5


def patch_grid(im: np.ndarray, patch_size: int = PATCH_SIZE):
    """im (H, W, C) float [0, 1] -> every patch of the ``patch_size`` grid,
    (N, P, P, C), row by row; a side under ``patch_size`` is reflect-padded
    to it first."""
    h, w = im.shape[:2]
    if h < patch_size or w < patch_size:
        ph, pw = max(0, patch_size - h), max(0, patch_size - w)
        im = np.pad(im, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = im.shape[:2]
    return np.stack([im[y:y + patch_size, x:x + patch_size]
                     for y in range(0, h - patch_size + 1, patch_size)
                     for x in range(0, w - patch_size + 1, patch_size)])


def patch_indexes(patches, num_patches: int, score_fn=std_score):
    """The indexes into ``patches`` of the ``num_patches`` highest scores,
    highest first (ties in the JAX package's order)."""
    scores = score_fn(patches)
    k = min(num_patches, len(scores))
    return np.argsort(scores)[::-1][:k]


def extract_patches(im: np.ndarray, num_patches: int,
                    patch_size: int = PATCH_SIZE, score_fn=std_score):
    """im (H, W, C) float [0, 1] -> the (k, P, P, C) highest-scoring
    patches."""
    patches = patch_grid(im, patch_size)
    return patches[patch_indexes(patches, num_patches, score_fn)]


def _run(model, x):
    device = next(model.parameters()).device
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device))


def predict_jpeg_quality(model, x, num_patches=8, patch_size=PATCH_SIZE):
    """x: an (H, W, C) image in [0, 1] or (N, P, P, C) patches ->
    (quality, probability of chroma subsampling)."""
    if x.ndim == 3:
        x = extract_patches(np.asarray(x), num_patches, patch_size)
    quality, subsampling = _run(model, x)
    quality = float(quality.float().mean().clamp(0, 100))
    return quality, float(torch.sigmoid(subsampling.float()).mean())


def predict_grain_noise_psnr(model, x, num_patches=8, patch_size=PATCH_SIZE):
    """50 - the predicted noise level (clamped to 0-50)."""
    if x.ndim == 3:
        x = extract_patches(np.asarray(x), num_patches, patch_size)
    noise_level = float(_run(model, x).float().mean().clamp(0, 50))
    return 50.0 - noise_level


def predict_resize_quality(model, x, num_patches=8, patch_size=PATCH_SIZE):
    """100 - (the least predicted scale factor - 1) x 100, truncated to an
    int as the JAX package does (so a factor within a rounding of a
    hundredth may land on either side)."""
    if x.ndim == 3:
        x = extract_patches(np.asarray(x), num_patches, patch_size,
                            score_fn=tv_score)
    scale_factor = float(_run(model, x).float().min())
    return 100 - int((scale_factor - 1.0) * 100)
