"""stlizer outpaint training addon (counterpart of
``nunif_tpu/stlizer/training.py``): ``python -m nunif_tpu_torch.train
stlizer_outpaint``.

The outpaint net learns to fill the border holes a stabilising warp
leaves: pairs of an image with a shifted-border mask and the full image.
The loss is the clamped L1 of the raw composite plus 0.5 x the clamped
8-window DCT loss of the net's output; the eval is the PSNR.  fp32,
plain PyTorch.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import create_model, init_flax_default
from ..modules import losses as L
from ..training.trainer import (Trainer, TrainerConfig, print_epoch_report,
                                to_device)
from ..utils.image_loader import list_images
from . import light_outpaint_v1  # noqa: F401  (registers the net)


def make_border_mask(rng, size):
    """A warp-like border mask: 1 outside a randomly shifted frame."""
    dx = int(rng.integers(0, size // 8 + 1)) * int(rng.choice([-1, 1]))
    dy = int(rng.integers(0, size // 8 + 1)) * int(rng.choice([-1, 1]))
    mask = np.ones((size, size, 1), np.float32)
    y0, y1 = max(0, dy), min(size, size + dy)
    x0, x1 = max(0, dx), min(size, size + dx)
    mask[y0:y1, x0:x1] = 0.0
    return mask


class OutpaintDataset:
    def __init__(self, input_dir, size=256, num_samples=200, seed=71):
        self.files = (list_images(input_dir)
                      if input_dir and os.path.isdir(input_dir) else [])
        self.size = size
        self.num_samples = num_samples
        self.seed = seed

    def batches(self, batch_size):
        from PIL import Image
        from ..waifu2x.training.generators import gen_random
        rng = np.random.default_rng(self.seed)
        for _i in range(0, self.num_samples, batch_size):
            ys, masks = [], []
            for _ in range(batch_size):
                if self.files:
                    f = self.files[int(rng.integers(0, len(self.files)))]
                    with Image.open(f) as im:
                        y = np.asarray(
                            im.convert("RGB").resize((self.size, self.size)),
                            np.float32) / 255.0
                else:
                    im = gen_random(self.size, seed=int(rng.integers(0, 2 ** 31)))
                    y = np.asarray(im.convert("RGB"), np.float32) / 255.0
                ys.append(y)
                masks.append(make_border_mask(rng, self.size))
            yield {"y": np.stack(ys), "mask": np.stack(masks)}


def make_outpaint_loss():
    """loss(out, z, y): clamped L1 of the raw composite ``out`` (which
    keeps gradients outside the mask) + 0.5 x the clamped 8-window DCT
    loss of the net's output ``z``."""
    dct = L.dct_loss(window_size=8, clamp=True, yrgb=False)
    l1 = L.clamp_loss_of(L.l1_loss)

    def loss(out, z, y):
        return l1(out, y) + dct(z, y) * 0.5
    return loss


def train_main(args):
    device = resolve_device(args.device)
    model = create_model("stlizer.light_outpaint_v1").to(device)
    init_flax_default(model, torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    outpaint_loss = make_outpaint_loss()

    def loss_fn(model, batch, generator):
        b = to_device(batch, device)
        x = b["y"] * (1.0 - b["mask"])
        out, z = model(x, b["mask"], train=True)
        return outpaint_loss(out, z, b["y"]), {}

    def eval_fn(model, batch):
        b = to_device(batch, device)
        x = b["y"] * (1.0 - b["mask"])
        return L.psnr(model(x, b["mask"]), b["y"])

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        scheduler=args.scheduler, seed=args.seed, resume=args.resume,
        ema_decay=args.ema_decay, checkpoint_name="stlizer_light_outpaint_v1")
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds = OutpaintDataset(os.path.join(args.data_dir, "train"),
                               size=args.size, num_samples=args.num_samples,
                               seed=args.seed)
    eval_ds = OutpaintDataset(os.path.join(args.data_dir, "eval"), size=args.size,
                              num_samples=max(args.num_samples // 10,
                                              args.batch_size),
                              seed=args.seed + 1)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("stlizer_outpaint", parents=[default_parser],
                              help="stlizer border outpaint net training")
    p.add_argument("--size", type=int, default=256)
    p.set_defaults(handler=train_main)
    return p
