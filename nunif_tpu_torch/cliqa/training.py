"""cliqa training addon, degradation-synthesis regression (counterpart
of ``nunif_tpu/cliqa/training.py``): ``python -m nunif_tpu_torch.train
cliqa --kind jpeg|noise|resize``.

Each patch is degraded with a known parameter (JPEG quality and chroma
subsampling, a gaussian noise level, a pre-upscale factor) that becomes
the regression target.  jpeg's loss is the L1 of the quality plus the
sigmoid BCE of the subsampling logit; the others the L1 of their one
output; the eval is the output's L1.  fp32, plain PyTorch.
"""
from __future__ import annotations

import random

import numpy as np
import torch
from PIL import Image

from ..core.device import resolve_device
from ..models import create_model, init_flax_default
from ..modules import losses as L
from ..training.trainer import (Trainer, TrainerConfig, print_epoch_report,
                                to_device)
from ..waifu2x.training.dataset import listdir_images
from ..waifu2x.training.degrade import _matrix_resize, add_jpeg_noise
from ..waifu2x.training.generators import gen_random
from . import models as _models  # noqa: F401  (registers cliqa.*)

ARCHS = {"jpeg": "cliqa.jpeg_quality", "noise": "cliqa.grain_noise_level",
         "resize": "cliqa.scale_factor"}


class CliqaDataset:
    """(patch, target) pairs with synthesized degradations; sample i draws
    from ``random.Random(hash((seed, i)))``."""

    def __init__(self, input_dir, kind: str, patch_size=128,
                 num_samples=10000, synthetic_p=0.0, seed=71, training=True):
        assert kind in ARCHS
        self.files = listdir_images(input_dir) if input_dir else []
        if not self.files and synthetic_p < 1.0:
            raise RuntimeError(f"{input_dir} is empty")
        self.kind = kind
        self.patch_size = patch_size
        self.num_samples = num_samples
        self.synthetic_p = synthetic_p
        self.training = training
        self.seed = seed

    def sample_pair(self, index):
        rng = random.Random(hash((self.seed, index)))
        ps = self.patch_size
        if not self.files or rng.random() < self.synthetic_p:
            im = gen_random(ps + 32, seed=rng.randint(0, 2 ** 31))
        else:
            im = Image.open(rng.choice(self.files))
            im.load()
            if im.mode != "RGB":
                im = im.convert("RGB")
        w, h = im.size
        if w < ps or h < ps:
            im = im.resize((max(w, ps), max(h, ps)), Image.LANCZOS)
            w, h = im.size
        x0, y0 = rng.randint(0, w - ps), rng.randint(0, h - ps)
        im = im.crop((x0, y0, x0 + ps, y0 + ps))

        if self.kind == "jpeg":
            quality = rng.randint(5, 99)
            subsampling = rng.random() < 0.5
            im = add_jpeg_noise(im, quality, "4:2:0" if subsampling else "4:4:4")
            x = np.asarray(im, np.float32) / 255.0
            return x, np.asarray([quality, float(subsampling)], np.float32)
        if self.kind == "noise":
            # noise level = 50 - PSNR: gaussian noise of a known sigma
            level = rng.uniform(0.0, 30.0)
            sigma = 10 ** (-(50.0 - level) / 20.0)
            x = np.asarray(im, np.float32) / 255.0
            noise = np.random.default_rng(index).normal(
                0, sigma, x.shape).astype(np.float32)
            return np.clip(x + noise, 0, 1), np.asarray([level], np.float32)
        # resize: down by 1/s, then back up (a known pre-upscale factor)
        s = rng.uniform(1.0, 2.0)
        arr = np.asarray(im, np.float32) / 255.0
        small = _matrix_resize(arr, int(ps / s), int(ps / s), "catrom")
        x = _matrix_resize(small, ps, ps, "catrom", antialias=False)
        return x.astype(np.float32), np.asarray([s], np.float32)

    def batches(self, batch_size):
        n = (self.num_samples // batch_size) * batch_size
        for start in range(0, n, batch_size):
            xs, ys = zip(*(self.sample_pair(i)
                           for i in range(start, start + batch_size)))
            yield {"x": np.stack(xs), "y": np.stack(ys)}


def make_cliqa_loss(kind: str):
    """(loss(out, y), eval(out, y)) of a predictor's training output."""
    def loss(out, y):
        if kind == "jpeg":
            quality, subsampling = out
            l_q = torch.mean(torch.abs(quality[:, 0] - y[:, 0]))
            l_s = torch.mean(L.sigmoid_bce(subsampling[:, 0], y[:, 1]))
            return l_q + l_s
        return torch.mean(torch.abs(out[:, 0] - y[:, 0]))

    def evaluate(out, y):
        if kind == "jpeg":
            out = out[0]
        return torch.mean(torch.abs(out[:, 0] - y[:, 0]))
    return loss, evaluate


def train_main(args):
    device = resolve_device(args.device)
    arch = ARCHS[args.kind]
    model = create_model(arch).to(device)
    init_flax_default(model, torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    loss, evaluate = make_cliqa_loss(args.kind)

    def loss_fn(model, batch, generator):
        b = to_device(batch, device)
        return loss(model(b["x"], train=True), b["y"]), {}

    def eval_fn(model, batch):
        b = to_device(batch, device)
        return evaluate(model(b["x"], train=False), b["y"])

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        seed=args.seed, resume=args.resume,
        checkpoint_name=arch.replace(".", "_"))
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds = CliqaDataset(
        args.data_dir, args.kind, patch_size=args.size,
        num_samples=args.num_samples, synthetic_p=args.synthetic_p,
        seed=args.seed)
    eval_ds = CliqaDataset(
        args.data_dir, args.kind, patch_size=args.size,
        num_samples=max(args.num_samples // 10, args.batch_size),
        synthetic_p=args.synthetic_p, seed=args.seed + 1, training=False)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("cliqa", parents=[default_parser],
                              help="cliqa quality-predictor training")
    p.add_argument("--kind", default="jpeg", choices=["jpeg", "noise", "resize"])
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--synthetic-p", type=float, default=0.0)
    p.set_defaults(handler=train_main)
    return p
