"""waifu2x training dataset: on-the-fly LR synthesis on the host (copied
from ``nunif_tpu/waifu2x/training/dataset.py``: a seed gives the same pairs
as the JAX dataset, which draws degradations from the global ``random``
and, in training, each pair's own generator from the dataset's).

Behavioral parity target: reference waifu2x/training/dataset.py:160-436 —
random crops from source images, random downscale with filter/blur lottery,
JPEG noise by level/style, augmentations (flip/rot, unsharp, grayscale),
synthetic screentone/dot/text mixing; model-offset target cropping.
``synthetic_p=1.0`` with no input directory trains on generated images
alone, so nothing is downloaded.

The loader is a thread-prefetched batch iterator producing numpy NHWC
batches; the trainer uploads each to the device.
"""
from __future__ import annotations

import os
import random
import threading
import queue as queue_mod

import numpy as np
from PIL import Image

from .degrade import RandomDownscale, RandomJPEGNoise, RandomUnsharpMask
from .generators import gen_random

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def listdir_images(d):
    out = []
    for root, _, files in os.walk(d):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(root, f))
    return out


class Waifu2xDataset:
    """Samples (x_lr, y_hr) pairs.

    y: (tile*scale - offset*2) crop of the HR image (model-offset centered),
    x: tile-sized LR input.
    """

    def __init__(self, input_dir, model_offset: int, scale_factor: int,
                 tile_size: int, style=None, noise_level: int = -1,
                 num_samples: int = 10000,
                 da_unsharpmask_p: float = 0.0, da_grayscale_p: float = 0.0,
                 da_hflip_only: bool = False, da_no_rotate: bool = False,
                 synthetic_p: float = 0.0,
                 resize_blur_p: float = 0.1, resize_blur_range: float = 0.05,
                 resize_step_p: float = 0.0, resize_no_antialias_p: float = 0.0,
                 bicubic_only: bool = False,
                 training: bool = True, seed: int = 71):
        self.files = listdir_images(input_dir) if input_dir else []
        if not self.files and synthetic_p < 1.0:
            raise RuntimeError(f"{input_dir} is empty")
        self.model_offset = model_offset
        self.scale = scale_factor
        self.tile_size = tile_size
        self.num_samples = num_samples
        self.training = training
        self.synthetic_p = synthetic_p
        self.da_unsharpmask_p = da_unsharpmask_p
        self.da_grayscale_p = da_grayscale_p
        self.da_hflip_only = da_hflip_only
        self.da_no_rotate = da_no_rotate
        self.rng = random.Random(seed)
        self.downscale = RandomDownscale(
            scale_factor,
            resize_blur_p=resize_blur_p, resize_blur_range=resize_blur_range,
            resize_step_p=resize_step_p,
            resize_no_antialias_p=resize_no_antialias_p,
            interpolation="catrom" if (bicubic_only or not training) else None,
            training=training)
        self.jpeg = (RandomJPEGNoise(style or "art", noise_level)
                     if noise_level >= 0 else None)
        self.unsharp = RandomUnsharpMask()

    def __len__(self):
        return self.num_samples

    # ------------------------------------------------------------ sampling
    def _load_source(self, rng) -> Image.Image:
        if not self.files or rng.random() < self.synthetic_p:
            return gen_random(self.tile_size * self.scale + 64,
                              seed=rng.randint(0, 2 ** 31))
        path = rng.choice(self.files)
        im = Image.open(path)
        im.load()
        if im.mode != "RGB":
            im = im.convert("RGB")
        return im

    def sample_pair(self, index: int):
        rng = random.Random((self.rng.random(), index).__hash__()) \
            if self.training else random.Random(index)
        hr_size = self.tile_size * self.scale
        im = self._load_source(rng)
        w, h = im.size
        if w < hr_size or h < hr_size:
            s = max(hr_size / w, hr_size / h)
            im = im.resize((int(w * s + 1), int(h * s + 1)), Image.LANCZOS)
            w, h = im.size
        x0 = rng.randint(0, w - hr_size)
        y0 = rng.randint(0, h - hr_size)
        y_im = im.crop((x0, y0, x0 + hr_size, y0 + hr_size))

        if self.training:
            if not self.da_no_rotate and not self.da_hflip_only \
                    and rng.random() < 0.5:
                y_im = y_im.transpose(Image.Transpose.ROTATE_90)
            if rng.random() < 0.5:
                y_im = y_im.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
            if not self.da_hflip_only and rng.random() < 0.5:
                y_im = y_im.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
            if self.da_grayscale_p and rng.random() < self.da_grayscale_p:
                y_im = y_im.convert("L").convert("RGB")
            if self.da_unsharpmask_p and rng.random() < self.da_unsharpmask_p:
                y_im = self.unsharp(y_im)

        x_im, y_im = self.downscale(y_im, y_im)
        if self.jpeg is not None:
            x_im, y_im = self.jpeg(x_im, y_im)

        x = np.asarray(x_im, np.float32) / 255.0
        y = np.asarray(y_im, np.float32) / 255.0
        off = self.model_offset
        if off > 0:
            y = y[off:-off, off:-off]
        return x, y

    # ------------------------------------------------------------- loading
    def batches(self, batch_size: int, n_threads: int = 4, drop_last=True,
                sampler=None):
        """Thread-prefetched epoch iterator of {"x","y"} numpy batches.

        With a HardExampleSampler, the epoch's sample indexes are drawn
        weighted-with-replacement and each batch carries an "index" array
        for per-sample loss feedback (reference
        waifu2x/training/trainer.py:697 + nunif/training/sampler.py)."""
        n = (self.num_samples // batch_size) * batch_size
        if sampler is not None:
            indexes = [int(i) % self.num_samples
                       for i in sampler.epoch_indexes()[:n]]
        else:
            indexes = list(range(n))
        q: queue_mod.Queue = queue_mod.Queue(maxsize=n_threads * 2)
        lock = threading.Lock()
        it = iter(range(0, n, batch_size))

        def worker():
            while True:
                with lock:
                    start = next(it, None)
                if start is None:
                    q.put(None)
                    return
                xs, ys = [], []
                for i in range(start, start + batch_size):
                    x, y = self.sample_pair(indexes[i])
                    xs.append(x)
                    ys.append(y)
                batch = {"x": np.stack(xs), "y": np.stack(ys)}
                if sampler is not None:
                    batch["index"] = np.asarray(
                        indexes[start:start + batch_size], np.int64)
                q.put(batch)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        done = 0
        while done < len(threads):
            item = q.get()
            if item is None:
                done += 1
                continue
            yield item
