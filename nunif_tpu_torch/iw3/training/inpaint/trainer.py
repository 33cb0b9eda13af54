"""iw3 inpaint training (counterpart of
``nunif_tpu/iw3/training/inpaint/trainer.py``): ``python -m
nunif_tpu_torch.train inpaint``.

The generator learns inside the hole only: its input is the image with
the hole blacked out and the mask, its output the composite.  The
reconstruction loss is clamped L1 plus an 8x8 DCT loss, and for the video
net (12-frame clips) twice the L1 of the frames' differences.

Without ``--discriminator`` the generic ``Trainer`` runs it (PSNR mode,
eval PSNR, the best model exported).  With ``--discriminator ffc|l3c``
the GAN step of ``training/gan.py`` runs in ``mask_hinge`` mode (only
logit cells over the hole count), with the adaptive weight, the
generator warmup and no R1, as the JAX trainer configures it; each epoch
prints an ``inpaint_gan: {...}`` line, appends every step's metrics to
``gan_steps.csv`` and exports the generator (its EMA when
``--ema-decay`` is set).  Both modes run fp32, the JAX trainer's dtype.
Nothing on this path reaches a hand-written kernel: the nets are plain
PyTorch (cuDNN convolutions, the gMLP's products).
"""
from __future__ import annotations

import csv
import json
import logging
import os
import time

import numpy as np
import torch

from ....core.device import resolve_device
from ....models import create_model, init_flax_default, save_model
from ....modules import losses as L
from ....training.gan import GANConfig, make_gan_train_step
from ....training.optimizers import create_optimizer
from ....training.schedules import constant_lr
from ....training.trainer import (Trainer, TrainerConfig, epoch_report,
                                  params_swapped, to_device)
from ... import models as _models  # noqa: F401  (registers the inpaint nets)
from .dataset import InpaintDataset, VideoInpaintDataset

logger = logging.getLogger("nunif_tpu_torch.iw3.training.inpaint")

DISCRIMINATORS = {"ffc": "inpaint.ffc_discriminator",
                  "l3c": "inpaint.l3_conditional_discriminator"}
VIDEO_ARCH = "inpaint.light_video_inpaint_v1"


def temporal_gradient_loss(x, y):
    """L1 of the adjacent-frame differences."""
    return torch.mean(torch.abs((x[:-1] - x[1:]) - (y[:-1] - y[1:])))


def make_recon_loss(video: bool):
    dct = L.dct_loss(window_size=8, clamp=True, yrgb=False)
    l1 = L.clamp_loss_of(L.l1_loss)

    def loss_fn(z, y):
        loss = l1(z, y) + dct(z, y)
        if video:
            loss = loss + temporal_gradient_loss(z, y) * 2.0
        return loss
    return loss_fn


def _mask_inputs(batch):
    """The generator's input: the hole-masked image and the mask (the
    inference preprocess, x * (1 - mask))."""
    return batch["y"] * (1.0 - batch["mask"]), batch["mask"]


def _datasets(args, video):
    ds_cls = VideoInpaintDataset if video else InpaintDataset

    def split(name):
        return os.path.join(args.data_dir, name) if args.data_dir else None
    train = ds_cls(split("train"), size=args.size,
                   num_samples=args.num_samples, seed=args.seed)
    eval_ = ds_cls(split("eval"), size=args.size,
                   num_samples=max(args.num_samples // 10, args.batch_size),
                   seed=args.seed + 1, training=False)
    return train, eval_


def create_generator(args, device):
    model = create_model(args.arch).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    init_flax_default(model, gen)
    return model.requires_grad_(True)


def gan_fit(args, model, device, video):
    """The GAN loop; returns the per-epoch reports."""
    disc = create_model(DISCRIMINATORS[args.discriminator]).to(device)
    init_flax_default(disc, torch.Generator(device=device).manual_seed(args.seed + 1))
    disc.requires_grad_(True)

    def g_apply(g, batch):
        x, mask = _mask_inputs(batch)
        return g(x, mask=mask, train=True)

    def d_apply(d, img, cond, mask):
        return d(img, c=cond, mask=mask, train=True)

    cfg = GANConfig(gan_loss="mask_hinge",
                    discriminator_weight=args.discriminator_weight,
                    generator_start_step=args.generator_start_step,
                    r1_gamma=0.0, ema_decay=args.ema_decay or 0.0)
    g_opt = create_optimizer("adam", model, constant_lr(args.learning_rate))
    d_opt = create_optimizer("adam", disc, constant_lr(args.learning_rate))
    init, step = make_gan_train_step(model, disc, g_apply, d_apply,
                                     make_recon_loss(video), g_opt, d_opt, cfg)
    state = init()
    train_ds, _eval = _datasets(args, video)
    os.makedirs(args.model_dir, exist_ok=True)
    csv_path = os.path.join(args.model_dir, "gan_steps.csv")
    out_path = os.path.join(args.model_dir, args.arch.replace(".", "_") + ".nztm")
    cuda = device.type == "cuda"
    reports = []
    names = ("recon", "gen", "d", "disc_weight")
    for epoch in range(args.max_epoch):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        first = state.step
        history, samples, wait = [], 0, 0.0
        t0 = time.perf_counter()
        batches = iter(train_ds.batches(args.batch_size))
        while True:
            tw = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - tw
            if batch is None:
                break
            batch = to_device(batch, device)
            batch["cond"] = batch["y"] * (1.0 - batch["mask"])
            samples += batch["y"].shape[0]
            m = step(state, batch)
            history.append(torch.stack([m[k].float() for k in names]))
        rows = torch.stack(history).cpu().numpy() if history else np.zeros((0, 4))
        wall = time.perf_counter() - t0
        with open(csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if f.tell() == 0:
                w.writerow(("epoch", "step") + names)
            for i, r in enumerate(rows):
                w.writerow((epoch, first + i, *(float(v) for v in r)))
        with params_swapped(model, state.g_ema_params):
            save_model(model, out_path)
        report = {"epoch": epoch, "steps": len(rows), "samples": samples,
                  "first_step": first,
                  "last": dict(zip(names, map(float, rows[-1]))) if len(rows) else None,
                  "finite": bool(np.isfinite(rows).all()),
                  "steps_per_second": len(rows) / wall if wall else None,
                  "samples_per_second": samples / wall if wall else None,
                  "data_wait_share": wait / wall if wall else None,
                  "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                        if cuda else None),
                  "exported_ema": state.g_ema_params is not None,
                  "device": str(device)}
        print("inpaint_gan: " + json.dumps(report), flush=True)
        reports.append(report)
    return reports


def recon_fit(args, model, device, video):
    """PSNR (recon-only) mode through the generic Trainer."""
    recon = make_recon_loss(video)

    def loss_fn(m, batch, generator):
        b = to_device(batch, device)
        x, mask = _mask_inputs(b)
        return recon(m(x, mask=mask, train=True), b["y"]), {}

    def eval_fn(m, batch):
        b = to_device(batch, device)
        x, mask = _mask_inputs(b)
        return L.psnr(m(x, mask=mask, train=False), b["y"])  # negative PSNR

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        scheduler=args.scheduler, seed=args.seed, resume=args.resume,
        ema_decay=args.ema_decay, checkpoint_name=args.arch.replace(".", "_"))
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds, eval_ds = _datasets(args, video)

    def report(tr, epoch, train_loss, eval_score):
        line = epoch_report(tr, epoch, train_loss, eval_score)
        del line["eval_score"]
        line["eval_psnr"] = None if eval_score is None else -eval_score
        print("train: " + json.dumps(line), flush=True)

    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size), on_epoch_end=report)
    return trainer


def train_main(args):
    device = resolve_device(args.device)
    video = args.arch == VIDEO_ARCH
    model = create_generator(args, device)
    logger.info("inpaint: %s, size %d, %s, on %s", args.arch, args.size,
                f"GAN ({args.discriminator})" if args.discriminator else "recon",
                device)
    if args.discriminator:
        gan_fit(args, model, device, video)
    else:
        recon_fit(args, model, device, video)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("inpaint", parents=[default_parser],
                              help="iw3 inpainting net training")
    p.add_argument("--arch", default="inpaint.light_inpaint_v1",
                   choices=["inpaint.light_inpaint_v1", VIDEO_ARCH])
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--discriminator", default=None,
                   choices=[None, "ffc", "l3c"])
    p.add_argument("--discriminator-weight", type=float, default=1.0)
    p.add_argument("--generator-start-step", type=int, default=0)
    p.set_defaults(handler=train_main)
    return p
