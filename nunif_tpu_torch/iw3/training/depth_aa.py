"""DepthAA training addon (counterpart of
``nunif_tpu/iw3/training/depth_aa.py``): ``python -m
nunif_tpu_torch.train depth_aa``.

The anti-aliasing net learns aliased depth -> smooth depth on synthetic
pairs (a smooth map, nearest-downscaled and upscaled by 2-4); losses
``dct`` (8 and 4 window DCT), ``l1`` or ``lbp``; the eval is the PSNR.
fp32, plain PyTorch (the net's window attention is plain in both
packages).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.device import resolve_device
from ...models import create_model
from ...modules import losses as L
from ...training.trainer import (Trainer, TrainerConfig, print_epoch_report,
                                 to_device)
from .. import models as _models  # noqa: F401  (registers iw3.depth_aa)


def make_criterion(kind: str):
    if kind == "dct":
        d8 = L.dct_loss(window_size=8, clamp=False, yrgb=False)
        d4 = L.dct_loss(window_size=4, clamp=False, yrgb=False)

        def fn(x, y):
            return d8(x, y) * 0.5 + d4(x, y) * 0.5
        return fn
    if kind == "l1":
        return L.l1_loss
    if kind == "lbp":
        return L.lbp_loss(in_channels=1, out_channels=64, kernel_size=3)
    raise ValueError(kind)


def _synth_depth(rng, size):
    """Smooth synthetic depth: a gradient plus radial blobs."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    d = rng.uniform() * xx + rng.uniform() * yy
    for _ in range(rng.integers(1, 5)):
        cx, cy = rng.uniform(), rng.uniform()
        r = rng.uniform(0.1, 0.4)
        d += np.clip(r - np.hypot(xx - cx, yy - cy), 0, None) * 2
    d = (d - d.min()) / max(d.max() - d.min(), 1e-6)
    return d[..., None].astype(np.float32)


def _alias(d, factor):
    """Nearest down + up: the staircase DepthAA removes."""
    small = d[::factor, ::factor]
    return np.repeat(np.repeat(small, factor, 0), factor, 1)[:d.shape[0],
                                                             :d.shape[1]]


class DepthAADataset:
    def __init__(self, size=128, num_samples=500, seed=71):
        self.size = size
        self.num_samples = num_samples
        self.seed = seed

    def batches(self, batch_size):
        rng = np.random.default_rng(self.seed)
        for _i in range(0, self.num_samples, batch_size):
            xs, ys = [], []
            for _ in range(batch_size):
                y = _synth_depth(rng, self.size)
                xs.append(_alias(y, int(rng.choice([2, 3, 4]))))
                ys.append(y)
            yield {"x": np.stack(xs), "y": np.stack(ys)}


def train_main(args):
    device = resolve_device(args.device)
    model = create_model("iw3.depth_aa").to(device)
    model.init_flax_default_(torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    criterion = make_criterion(args.loss)

    def loss_fn(model, batch, generator):
        b = to_device(batch, device)
        return criterion(model(b["x"], train=True), b["y"]), {}

    def eval_fn(model, batch):
        b = to_device(batch, device)
        return L.psnr(model(b["x"], train=False), b["y"])

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        scheduler=args.scheduler, seed=args.seed, resume=args.resume,
        ema_decay=args.ema_decay, checkpoint_name="iw3_depth_aa")
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds = DepthAADataset(size=args.size, num_samples=args.num_samples,
                              seed=args.seed)
    eval_ds = DepthAADataset(size=args.size,
                             num_samples=max(args.num_samples // 10,
                                             args.batch_size),
                             seed=args.seed + 1)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("depth_aa", parents=[default_parser],
                              help="iw3 depth anti-aliasing net training")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--loss", default="dct", choices=["dct", "l1", "lbp"])
    p.set_defaults(handler=train_main)
    return p
