"""SBS warp-net training addon (counterpart of
``nunif_tpu/iw3/training/sbs/trainer.py``): ``python -m
nunif_tpu_torch.train sbs`` and ``python -m
nunif_tpu_torch.create_training_data sbs``.

The net gives the delta (row_flow_v2 / v3) or the layers' deltas and
their blend weights (MLBW); the loss warps the rgb by them with
``backward_warp_delta`` (the gather, as the inference path without a
shift bound), crops the net's offset, down-weights the disoccluded pixels
and sums three windowed DCT losses and the warp points' monotonicity
penalty.  It runs fp32, the JAX trainer's dtype, on the device the
caller names (the card by default).  No hand-written kernel is on this
path: the nets' window attention is plain PyTorch, as the JAX package
leaves it to XLA, and the warp is the gather.
"""
from __future__ import annotations

import logging
import os

import torch

from ....core.device import resolve_device
from ....models import create_model, init_flax_default
from ....modules import losses as L
from ....modules.pad import crop2d
from ....modules.pool import avg_pool2d
from ....training.trainer import (Trainer, TrainerConfig, print_epoch_report,
                                  to_device)
from ... import models as _models  # noqa: F401  (registers the sbs nets)
from ...backward_warp import backward_warp_delta, make_input_tensor
from .dataset import SBSDataset, synthesize_quads

logger = logging.getLogger("nunif_tpu_torch.iw3.training.sbs")

ARCHS = ["sbs.row_flow_v3", "sbs.row_flow_v2", "sbs.mlbw_l2", "sbs.mlbw_l4"]


def delta_penalty(warp_points):
    """Mean of the warp points' decreases along x over steps of 1 and 2,
    divided by 3.  warp_points: (B, H, W)."""
    penalty = 0.0
    for i in range(1, 3):
        penalty = penalty + torch.mean(
            torch.relu(warp_points[:, :, :-i] - warp_points[:, :, i:]))
    return penalty / 3.0


def make_sbs_loss(model, model_offset: int, mask_weight: float = 0.75):
    """(loss_fn(model, batch, generator) -> (loss, {}), eval_fn(model,
    batch) -> loss) on numpy batches of ``SBSDataset``, moved to the
    model's device."""
    dct24 = L.dct_loss(window_size=24, clamp=True, yrgb=False)
    dct4 = L.dct_loss(window_size=4, clamp=True, yrgb=False)
    dct8 = L.dct_loss(clamp=True, yrgb=False)
    is_mlbw = model.model_name == "sbs.mlbw"

    def loss_fn(model, batch, generator):
        divergence = float(batch["divergence"][0])   # the batch's first
        b = to_device(batch, next(model.parameters()).device)
        rgb = b["rgb"]
        B, H, W, _ = rgb.shape
        x = make_input_tensor(None, b["depth"][..., None], divergence,
                              b["convergence"], image_width=max(H, W))
        out = model(x, train=True)
        delta_scale = 1.0 / (W // 2 - 1)
        x_index = torch.arange(W, dtype=torch.float32,
                               device=rgb.device).reshape(1, 1, W)
        if is_mlbw:
            delta, layer_weight = out[0], out[1]
            z = torch.zeros_like(rgb)
            wp = 0.0
            for i in range(model.num_layers):
                z = z + (backward_warp_delta(rgb, delta[..., i], delta_scale)
                         * layer_weight[..., i:i + 1])
                wp = wp + (x_index + delta[..., i]) * layer_weight[..., i]
        else:
            delta = out[..., 0]
            z = backward_warp_delta(rgb, delta, delta_scale)
            wp = x_index + delta
        z = crop2d(z, (model_offset,) * 4)
        y, mask = b["y"], b["mask"]
        if mask_weight > 0:
            m = 1.0 - torch.clamp(mask + avg_pool2d(mask, 3), 0, 1) * mask_weight
            z = z * m
            y = y * m
        loss = (dct24(z, y) + dct4(z, y) + dct8(z, y)) * 0.3
        return loss + delta_penalty(wp), {}

    def eval_fn(model, batch):
        return loss_fn(model, batch, None)[0]

    return loss_fn, eval_fn


def build_trainer(args):
    """(trainer, train dataset, eval dataset) from parsed arguments: the
    net at flax's initialisation from ``--seed`` on ``--device``."""
    device = resolve_device(args.device)
    model = create_model(args.arch).to(device)
    init_flax_default(model, torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    loss_fn, eval_fn = make_sbs_loss(model, model.i2i_offset,
                                     mask_weight=args.mask_weight)
    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        scheduler=args.scheduler, seed=args.seed, resume=args.resume,
        ema_decay=args.ema_decay, checkpoint_name=args.arch.replace(".", "_"))
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds = SBSDataset(os.path.join(args.data_dir, "train"), args.size,
                          model.i2i_offset, num_samples=args.num_samples,
                          seed=args.seed)
    eval_ds = SBSDataset(os.path.join(args.data_dir, "eval"), args.size,
                         model.i2i_offset,
                         num_samples=max(args.num_samples // 10, args.batch_size),
                         training=False)
    return trainer, train_ds, eval_ds


def train_main(args):
    trainer, train_ds, eval_ds = build_trainer(args)
    logger.info("sbs: %s, size %d, mask weight %s, on %s", args.arch,
                args.size, args.mask_weight, trainer.device)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def create_training_data_main(args):
    n = 0
    for split in ("train", "eval"):
        n += synthesize_quads(
            args.dataset_dir if args.dataset_dir != "synthetic" else None,
            os.path.join(args.data_dir, split),
            n_per_image=args.n_per_image, size=args.size,
            divergence=args.divergence, convergence=args.convergence,
            seed=71 if split == "train" else 137, device=args.device)
    logger.info("sbs: synthesized %d quads", n)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("sbs", parents=[default_parser],
                              help="iw3 stereo warp net training")
    p.add_argument("--arch", default="sbs.row_flow_v3", choices=ARCHS)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--mask-weight", type=float, default=0.75)
    p.set_defaults(handler=train_main)
    return p


def register_create_training_data(subparsers, default_parser):
    p = subparsers.add_parser("sbs", parents=[default_parser],
                              help="synthesize sbs warp training quads")
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--n-train", type=int, default=8)
    p.add_argument("--n-eval", type=int, default=2)
    p.add_argument("--n-per-image", type=int, default=2)
    p.add_argument("--divergence", type=float, default=2.0)
    p.add_argument("--convergence", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="the device of the forward warp: cuda (default) or cpu")
    p.set_defaults(handler=create_training_data_main)
    return p
