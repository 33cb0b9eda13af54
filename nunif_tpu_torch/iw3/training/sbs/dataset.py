"""SBS (stereo warp net) training data (counterpart of
``nunif_tpu/iw3/training/sbs/dataset.py``): quads of ``<base>_C.png``
(rgb), ``_D.png`` (16-bit depth with divergence / convergence text
chunks), ``_L.png`` (the left view target) and ``_M.png`` (the
disocclusion mask).

``synthesize_quads`` builds quads from plain images (or generated ones)
with the depth-ordered forward warp as ground truth; it runs the warp on
``device``, the card unless the caller names the CPU.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch
from PIL import Image

from ...depth.base import BaseDepthModel


def load_quad(base_path):
    out = []
    for suffix in ("_C.png", "_D.png", "_L.png", "_M.png"):
        im = Image.open(base_path + suffix)
        im.load()
        out.append(im)
    return out


def list_quads(input_dir):
    return [os.path.join(input_dir, f[:-len("_C.png")])
            for f in sorted(os.listdir(input_dir)) if f.endswith("_C.png")]


class SBSDataset:
    """Yields numpy batches {"rgb", "depth", "y", "mask", "divergence",
    "convergence"} of ``size`` crops; ``y`` and ``mask`` are cropped by the
    net's offset.  A training sample's crop comes from
    ``random.Random(hash((seed, index)))``, an eval sample's is centred."""

    def __init__(self, input_dir, size: int, model_offset: int,
                 num_samples=1000, training=True, seed=71):
        self.bases = list_quads(input_dir)
        if not self.bases:
            raise RuntimeError(f"{input_dir}: no *_C.png quads")
        self.size = size
        self.model_offset = model_offset
        self.num_samples = num_samples
        self.training = training
        self.seed = seed

    def sample(self, index):
        rng = random.Random(hash((self.seed, index)) if self.training
                            else index)
        base = self.bases[index % len(self.bases)]
        im_c, _im_d, im_l, im_m = load_quad(base)
        depth, meta = BaseDepthModel.load_depth(base + "_D.png")
        divergence = float(meta.get("divergence", 2.0))
        convergence = float(meta.get("convergence", 0.5))

        s = self.size
        W, H = im_c.size
        if self.training:
            x0 = rng.randint(0, max(0, W - s))
            y0 = rng.randint(0, max(0, H - s))
        else:
            x0, y0 = max(0, (W - s) // 2), max(0, (H - s) // 2)
        box = (x0, y0, x0 + s, y0 + s)
        c = np.asarray(im_c.crop(box), np.float32) / 255.0
        le = np.asarray(im_l.crop(box), np.float32) / 255.0
        m = np.asarray(im_m.crop(box), np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        m = (m > 0).astype(np.float32)[..., None]
        d = np.asarray(depth)[y0:y0 + s, x0:x0 + s]
        if d.ndim == 3:
            d = d[..., 0]

        off = self.model_offset
        return {
            "rgb": c, "depth": d.astype(np.float32),
            "y": le[off:-off, off:-off] if off else le,
            "mask": m[off:-off, off:-off] if off else m,
            "divergence": np.float32(divergence),
            "convergence": np.float32(convergence),
        }

    def batches(self, batch_size):
        n = (self.num_samples // batch_size) * batch_size
        for start in range(0, n, batch_size):
            items = [self.sample(i) for i in range(start, start + batch_size)]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def synthetic_depth(rng: random.Random, size: int) -> np.ndarray:
    """A smooth (size, size) depth in [0, 1]: a random gradient plus 1-4
    radial blobs, drawn from ``rng``."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    d = rng.random() * xx + rng.random() * yy
    for _b in range(rng.randint(1, 4)):
        cx, cy = rng.random(), rng.random()
        r = rng.uniform(0.1, 0.4)
        d += np.clip(r - np.hypot(xx - cx, yy - cy), 0, None) * 2
    return (d - d.min()) / max(d.max() - d.min(), 1e-6)


def synthesize_quads(image_dir, out_dir, n_per_image=2, size=320,
                     divergence=2.0, convergence=0.5, seed=71, device="cuda"):
    """Write training quads cut from the images of ``image_dir`` (at least
    8 sources: generated ones without a directory), the left view and its
    mask from the forward warp on ``device``.  Returns the count."""
    from ....core.device import resolve_device
    from ....waifu2x.training.dataset import listdir_images
    from ....waifu2x.training.generators import gen_random
    from ...forward_warp import depth_order_bilinear_forward_warp

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    files = listdir_images(image_dir) if image_dir else []
    rng = random.Random(seed)
    count = 0
    for i in range(max(len(files), 8)):
        if files:
            im = Image.open(files[i % len(files)])
            im.load()
            if im.mode != "RGB":
                im = im.convert("RGB")
        else:
            im = gen_random(size + 64, seed=rng.randint(0, 2 ** 31))
        W, H = im.size
        if W < size or H < size:
            im = im.resize((max(W, size), max(H, size)), Image.LANCZOS)
            W, H = im.size
        for _ in range(n_per_image):
            x0 = rng.randint(0, W - size)
            y0 = rng.randint(0, H - size)
            crop = im.crop((x0, y0, x0 + size, y0 + size))
            c = np.asarray(crop, np.float32) / 255.0
            d = synthetic_depth(rng, size)
            with torch.no_grad():
                left, _right, lmask, _rmask = depth_order_bilinear_forward_warp(
                    torch.from_numpy(c[None]).to(device),
                    torch.from_numpy(d[None, ..., None]).to(device),
                    divergence, convergence, fill=True, synthetic_view="both",
                    return_mask=True)
            left = left[0].float().cpu().numpy()
            lmask = lmask[0, ..., 0].float().cpu().numpy()
            base = os.path.join(out_dir, f"{count:06d}")
            crop.save(base + "_C.png")
            BaseDepthModel.save_normalized_depth(
                d[..., None], base + "_D.png",
                png_info={"divergence": divergence, "convergence": convergence})
            Image.fromarray((left * 255 + 0.5).astype(np.uint8)).save(base + "_L.png")
            Image.fromarray((lmask * 255).astype(np.uint8)).save(base + "_M.png")
            count += 1
    return count
