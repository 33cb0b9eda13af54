"""SOD (salient-object detection) training addon (counterpart of
``nunif_tpu/iw3/training/sod.py``): ``python -m nunif_tpu_torch.train
sod``.

SODV1 (U2NETP on rgb + depth features) trains on the equally weighted BCE
of its seven deep-supervision maps, which come at the net's internal 192
px: the target is resized to them (bilinear, antialiased).  The eval is
the PSNR of the probability map at the input size.  Data: ``img/`` and
``mask/`` under each split, or synthetic shapes where there are none.
fp32, plain PyTorch (cuDNN convolutions).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ...core.device import resolve_device
from ...models import create_model, init_flax_default
from ...modules import losses as L
from ...modules.resize import resize
from ...training.trainer import (Trainer, TrainerConfig, print_epoch_report,
                                 to_device)
from ...utils.image_loader import list_images
from .. import models as _models  # noqa: F401  (registers iw3.sod_v1)


def multi_bce(outputs, target, eps=1e-6):
    """Equally weighted BCE of the probability maps ``outputs`` (one map
    or a sequence) against ``target``, the probabilities clipped to [eps,
    1 - eps]."""
    outs = outputs if isinstance(outputs, (tuple, list)) else [outputs]
    w = 1.0 / len(outs)
    loss = 0.0
    for p in outs:
        p = torch.clamp(p.float(), eps, 1.0 - eps)
        loss = loss + torch.mean(-(target * torch.log(p)
                                   + (1 - target) * torch.log1p(-p))) * w
    return loss


def _synth_sample(rng, size):
    """Random discs on a textured background: x is rgb + depth (the
    salient discs nearer), y the discs' mask."""
    bg = rng.uniform(0, 1, (size, size, 3)).astype(np.float32) * 0.3
    depth = rng.uniform(0, 0.3, (size, size, 1)).astype(np.float32)
    mask = np.zeros((size, size, 1), np.float32)
    for _ in range(rng.integers(1, 4)):
        cy, cx = rng.integers(0, size, 2)
        r = int(rng.integers(size // 8, size // 3))
        yy, xx = np.mgrid[0:size, 0:size]
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        color = rng.uniform(0.5, 1.0, (3,)).astype(np.float32)
        bg[blob] = color
        depth[blob] = rng.uniform(0.6, 1.0)
        mask[blob] = 1.0
    return np.concatenate([bg, depth], axis=-1), mask


class SODDataset:
    def __init__(self, input_dir, size=256, num_samples=500, seed=71):
        img_dir = os.path.join(input_dir, "img") if input_dir else ""
        self.files = list_images(img_dir) if os.path.isdir(img_dir) else []
        self.mask_dir = os.path.join(input_dir, "mask") if input_dir else ""
        self.size = size
        self.num_samples = num_samples
        self.seed = seed

    def batches(self, batch_size):
        from PIL import Image
        rng = np.random.default_rng(self.seed)
        for _i in range(0, self.num_samples, batch_size):
            xs, ys = [], []
            for _ in range(batch_size):
                if self.files:
                    f = self.files[int(rng.integers(0, len(self.files)))]
                    mf = os.path.join(
                        self.mask_dir,
                        os.path.splitext(os.path.basename(f))[0] + ".png")
                    with Image.open(f) as im:
                        rgb = np.asarray(im.convert("RGB").resize(
                            (self.size, self.size)), np.float32) / 255.0
                    with Image.open(mf) as im:
                        y = np.asarray(im.convert("L").resize(
                            (self.size, self.size)), np.float32)[..., None] / 255.0
                    # the luminance stands in for the depth channel
                    lum = rgb.mean(axis=-1, keepdims=True)
                    x = np.concatenate([rgb, lum], axis=-1)
                else:
                    x, y = _synth_sample(rng, self.size)
                xs.append(x)
                ys.append(y)
            yield {"x": np.stack(xs), "y": np.stack(ys)}


def sod_loss(outputs, y):
    """``multi_bce`` of the training outputs, y resized to their size
    (bilinear, antialiased) when it differs."""
    ref = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    if tuple(y.shape[1:3]) != tuple(ref.shape[1:3]):
        y = resize(y, ref.shape[1], ref.shape[2], mode="bilinear", antialias=True)
    return multi_bce(outputs, y)


def train_main(args):
    device = resolve_device(args.device)
    model = create_model("iw3.sod_v1").to(device)
    init_flax_default(model, torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)

    def loss_fn(model, batch, generator):
        b = to_device(batch, device)
        return sod_loss(model(b["x"], train=True), b["y"]), {}

    def eval_fn(model, batch):
        b = to_device(batch, device)
        return L.psnr(model(b["x"], train=False), b["y"])

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        scheduler=args.scheduler, seed=args.seed, resume=args.resume,
        ema_decay=args.ema_decay, checkpoint_name="iw3_sod_v1")
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds = SODDataset(os.path.join(args.data_dir, "train"),
                          size=args.size, num_samples=args.num_samples,
                          seed=args.seed)
    eval_ds = SODDataset(os.path.join(args.data_dir, "eval"), size=args.size,
                         num_samples=max(args.num_samples // 10,
                                         args.batch_size),
                         seed=args.seed + 1)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("sod", parents=[default_parser],
                              help="iw3 salient-object-detection training")
    p.add_argument("--size", type=int, default=256)
    p.set_defaults(handler=train_main)
    return p
