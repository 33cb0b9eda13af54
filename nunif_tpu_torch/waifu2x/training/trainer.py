"""waifu2x training app, PSNR mode (counterpart of
``nunif_tpu/waifu2x/training/trainer.py``): the loss table, the per-arch
dataset offsets, the luminance-PSNR eval, checkpoints and the best-model
export.

The model trains on its device through the generic trainer
(``training/trainer.py``).  On the card the training forward runs in
bf16, the kernels' dtype (``core/dtypes.BF16_POLICY``: fp32 parameters,
bf16 compute), and the loss is taken on the fp32 output; swin_unet's
forward runs K1 and K2, whose backward is their twins' vector-Jacobian
product (``ops/_build.register_twin_vjp``).  On the CPU it runs fp32, as
the JAX trainer does on the batch's fp32 values.

The feature-net losses build their nets once, on the CPU, and move them
to the loss's device at its first call: ``l1lpips*`` (LPIPS, a VGG16
trunk: torchvision weights from the ``.pth`` that ``NUNIF_LPIPS_VGG``
names, else seeded random), ``l1dinov2*`` / ``yrgb_lbp_dinov2`` (the
DINOv2 ViT-S trunk in bf16, its attention kernel K7, seeded random) and
``l1l4sn*`` (L4SN, seeded random).  No pretrained feature-net weights are
in the repository, and nothing is downloaded.
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from ...core.device import resolve_device
from ...models import create_model, init_flax_default
from ...modules import losses as L
from ...training.trainer import Trainer, TrainerConfig
from ...training.trainer import epoch_report as training_epoch_report
from .dataset import Waifu2xDataset

logger = logging.getLogger("nunif_tpu_torch.waifu2x.training")

def _aux(loss_fn):
    return L.auxiliary_loss((loss_fn, loss_fn), (1.0, 0.5))


def _lpips_criterion(base_loss, weight, std_mask=False):
    """base + weight * LPIPS.  The VGG16 trunk converts from the
    torchvision ``vgg16`` ``.pth`` that ``NUNIF_LPIPS_VGG`` names; without
    one it is flax's initialisation from seed 0."""
    from ...models import from_flax
    from ...models.pth_import import load_torch_checkpoint
    from ...models.torch_convert import convert_vgg16_features, flatten
    from ...modules.lpips import LPIPS, lpips_with

    model = LPIPS()
    vgg_ckpt = os.environ.get("NUNIF_LPIPS_VGG")
    if vgg_ckpt:
        _n, _k, sd = load_torch_checkpoint(vgg_ckpt)
        from_flax(model, flatten({"net": convert_vgg16_features(sd)}))
    else:
        logger.warning("LPIPS: seeded random VGG trunk "
                       "(set NUNIF_LPIPS_VGG=<torchvision vgg16 .pth>)")
        init_flax_default(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    return _on_device(model, lpips_with(model, base_loss, weight=weight,
                                        std_mask=std_mask))


def _l4sn_criterion(base_loss, weight, swd_weight=0.0):
    """base + weight * the L4SN feature loss (+ the sliced-Wasserstein
    term), on flax's initialisation from seed 0."""
    from ...dino.l4sn import L4SNFeature, l4sn_feature_loss

    model = L4SNFeature()
    logger.warning("L4SN: seeded random feature net (train one with the "
                   "dino addon for the reference's trained weights)")
    init_flax_default(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)

    def fn(x, y):
        return base_loss(x, y) + l4sn_feature_loss(
            model, x, y, weight=weight, swd_weight=swd_weight)
    return _on_device(model, fn)


def _on_device(model, fn):
    """fn with ``model`` moved to the device of fn's first input."""
    def wrapped(x, y):
        if next(model.parameters()).device != x.device:
            model.to(x.device)
        return fn(x, y)
    return wrapped


def create_criterion(name: str):
    """The loss of the reference's LOSS_FUNCTIONS table by name (the JAX
    package's full table).  Random-augmented entries are marked
    ``needs_rng`` and take the trainer's generator."""
    from ...modules.dinov2_loss import dinov2_with
    clamp_l1 = lambda: L.clamp_loss_of(L.l1_loss)  # noqa: E731
    alex11 = lambda: L.clamp_loss_of(                       # noqa: E731
        L.luminance_weighted(L.alex11_loss(in_channels=1)))
    table = {
        "l1": clamp_l1,
        "y_l1": lambda: L.luminance_weighted(L.clamp_loss_of(L.l1_loss)),
        "charbonnier": lambda: L.clamp_loss_of(L.charbonnier_loss),
        "y_charbonnier": lambda: L.luminance_weighted(
            L.clamp_loss_of(L.charbonnier_loss)),
        "lbp": lambda: L.ylbp_loss(kernel_size=3),
        "lbpm": lambda: L.multiscale_loss(L.ylbp_loss(kernel_size=3)),
        "lbp5": lambda: L.ylbp_loss(kernel_size=5),
        "lbp5m": lambda: L.multiscale_loss(L.ylbp_loss(kernel_size=5)),
        "yrgb_l1lbp5": lambda: L.yrgb_l1_lbp_loss(kernel_size=5, weight=0.4),
        "yrgb_l1lbp": lambda: L.yrgb_l1_lbp_loss(kernel_size=3, weight=0.4),
        "yrgb_flatlbp5": lambda: L.yrgb_flat_lbp_loss(kernel_size=5,
                                                      weight=0.4),
        "yrgb_lbp": lambda: L.yrgb_lbp_loss(kernel_size=3),
        "yrgb_lbp5": lambda: L.yrgb_lbp_loss(kernel_size=5),
        "alex11": alex11,
        "y_l1fftgrad": lambda: L.yrgb_l1_fft_gradient_loss(
            fft_weight=0.1, grad_weight=0.1, diag=False),
        "dct": lambda: L.dct_loss_ex(window_size=None, clamp=True),
        "dctirm": lambda: L.dctirm_loss(),
        "dctir24": lambda: L.dctir24_loss(),
        "fft": lambda: L.fft_loss(),
        "aux_lbp": lambda: _aux(L.ylbp_loss(kernel_size=3)),
        "aux_alex11": lambda: _aux(alex11()),
        "aux_charbonnier": lambda: _aux(L.clamp_loss_of(L.charbonnier_loss)),
        "aux_y_charbonnier": lambda: _aux(
            L.luminance_weighted(L.clamp_loss_of(L.charbonnier_loss))),
        "aux_lbp_ident": lambda: L.auxiliary_loss(
            (L.ylbp_loss(kernel_size=3), L.identity_loss()), (1.0, 1.0)),
        "ident": lambda: L.identity_loss(),
        "l1lpips": lambda: _lpips_criterion(clamp_l1(), weight=0.4),
        "l1lpips_std_mask": lambda: _lpips_criterion(
            clamp_l1(), weight=0.4, std_mask=True),
        "l1lpips_dct24": lambda: _lpips_criterion(
            L.weighted_loss(
                (clamp_l1(),
                 L.dct_loss_ex(window_size=24, clamp=True, overlap=True)),
                (1.0, 0.2)),
            weight=0.4),
        "l1dinov2": lambda: dinov2_with(clamp_l1(), kind="pool", weight=0.1),
        "l1dinov2_10": lambda: dinov2_with(clamp_l1(), kind="pool",
                                           weight=1.0),
        "yrgb_lbp_dinov2": lambda: dinov2_with(
            L.yrgb_lbp_loss(kernel_size=3), kind="cosine", weight=2.0),
        "l1l4sn": lambda: _l4sn_criterion(clamp_l1(), weight=1.0),
        "l1l4sn2": lambda: _l4sn_criterion(clamp_l1(), weight=2.0),
        "l1l4sn_swd": lambda: _l4sn_criterion(clamp_l1(), weight=1.0,
                                              swd_weight=0.1),
    }
    if name not in table:
        raise ValueError(f"unknown loss: {name} (known: {sorted(table)})")
    return table[name]()


DEFAULT_LOSSES = {
    "waifu2x.vgg_7": "y_charbonnier",
    "waifu2x.upconv_7": "y_charbonnier",
    "waifu2x.cunet": "aux_lbp",
    "waifu2x.upcunet": "aux_lbp",
    "waifu2x.swin_unet_1x": "lbp",
    "waifu2x.swin_unet_2x": "lbp",
    "waifu2x.swin_unet_4x": "lbp5",
    "waifu2x.swin_unet_v2_1x": "lbp",
    "waifu2x.swin_unet_v2_2x": "lbp",
    "waifu2x.swin_unet_v2_4x": "lbp5",
    "waifu2x.turbo_2x": "y_charbonnier",
}


def _to_device(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


class Waifu2xTrainerApp:
    """Dataset, model, loss and trainer from parsed arguments; ``fit()``
    runs the training: bf16 compute on the card, fp32 on the CPU."""

    def __init__(self, args):
        self.args = args
        self.device = device = resolve_device(args.device)
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        model = create_model(args.arch)
        self.tile_size = tile = model.find_valid_tile_size(args.size)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        model.to(device)
        init_flax_default(model, gen)
        model.requires_grad_(True)
        self.model = model

        self.loss_name = args.loss or DEFAULT_LOSSES.get(args.arch, "y_charbonnier")
        base_loss = create_criterion(self.loss_name)
        aux = self.loss_name.startswith("aux_")
        needs_rng = getattr(base_loss, "needs_rng", False)

        def loss_fn(model, batch, generator):
            x = _to_device(batch["x"], device, compute_dtype)
            y = _to_device(batch["y"], device)
            pred = model(x, train=True)
            kw = {"generator": generator} if needs_rng else {}
            if aux and isinstance(pred, tuple):
                return base_loss(tuple(p.float() for p in pred), y, **kw), {}
            if isinstance(pred, tuple):
                pred = pred[0]
            return base_loss(pred.float(), y, **kw), {}

        def eval_fn(model, batch):
            pred = model(_to_device(batch["x"], device, compute_dtype),
                         train=False)
            if isinstance(pred, tuple):
                pred = pred[0]
            # negative Y-PSNR: smaller is better
            return L.luminance_psnr(pred.float(), _to_device(batch["y"], device))

        cfg = TrainerConfig(
            model_dir=args.model_dir, max_epoch=args.max_epoch,
            optimizer=args.optimizer, learning_rate=args.learning_rate,
            weight_decay=args.weight_decay, scheduler=args.scheduler,
            accum_steps=args.backward_steps, ema_decay=args.ema_decay,
            seed=args.seed, resume=args.resume,
            checkpoint_name=args.arch.replace(".", "_"))
        self.trainer = Trainer(cfg, model, loss_fn, eval_fn,
                               steps_per_epoch=args.num_samples // args.batch_size)

        common = dict(
            model_offset=model.i2i_offset, scale_factor=model.i2i_scale,
            tile_size=tile, style=args.style, noise_level=args.noise_level,
            synthetic_p=args.synthetic_p,
            bicubic_only=args.deblur == 0 and args.bicubic_only)
        self.train_ds = Waifu2xDataset(
            os.path.join(args.data_dir, "train") if args.data_dir else None,
            num_samples=args.num_samples,
            da_unsharpmask_p=args.da_unsharpmask_p,
            da_grayscale_p=args.da_grayscale_p,
            training=True, seed=args.seed, **common)
        self.eval_ds = Waifu2xDataset(
            os.path.join(args.data_dir, "eval") if args.data_dir else None,
            num_samples=max(args.num_samples // 10, args.batch_size),
            training=False, seed=args.seed + 1, **common)

    def fit(self, on_epoch_end=None):
        args = self.args
        sampler = None
        if args.hard_example != "none":
            from ...training.sampler import HardExampleSampler, MiningMethod
            method = {"linear": MiningMethod.LINEAR,
                      "top10": MiningMethod.TOP10,
                      "top20": MiningMethod.TOP20}[args.hard_example]
            sampler = HardExampleSampler(
                self.train_ds.num_samples, method=method,
                scale_factor=args.hard_example_scale, seed=args.seed)
        self.sampler = sampler
        self.trainer.fit(
            lambda: self.train_ds.batches(args.batch_size,
                                          n_threads=args.num_workers,
                                          sampler=sampler),
            lambda: self.eval_ds.batches(args.batch_size,
                                         n_threads=args.num_workers),
            hard_sampler=sampler, on_epoch_end=on_epoch_end)
        return self.trainer


def epoch_report(trainer, epoch, train_loss, eval_score) -> dict:
    """``training.trainer.epoch_report`` with the eval score as the eval
    Y-PSNR in dB (``eval_y_psnr``)."""
    report = training_epoch_report(trainer, epoch, train_loss, eval_score)
    del report["eval_score"]
    report["eval_y_psnr"] = None if eval_score is None else -eval_score
    return report


def train_main(args):
    app = Waifu2xTrainerApp(args)
    logger.info("waifu2x: %s, loss %s, tile %d, batch %d, %s on %s",
                args.arch, app.loss_name, app.tile_size, args.batch_size,
                args.optimizer, app.device)

    def report(trainer, epoch, train_loss, eval_score):
        print("train: " + json.dumps(epoch_report(trainer, epoch, train_loss,
                                                 eval_score)), flush=True)

    trainer = app.fit(on_epoch_end=report)
    exported = sorted(f for f in os.listdir(args.model_dir) if f.endswith(".nztm"))
    print("exported: " + json.dumps(
        {"files": exported, "best_eval_y_psnr": -trainer.best_score}), flush=True)
    return 0


def create_training_data_main(args):
    """Split source images into training tiles (train / eval)."""
    from PIL import Image
    from .dataset import listdir_images
    files = listdir_images(args.dataset_dir)
    os.makedirs(os.path.join(args.data_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(args.data_dir, "eval"), exist_ok=True)
    n_eval = max(1, int(len(files) * args.eval_rate))
    size = args.size
    count = 0
    for i, f in enumerate(files):
        split = "eval" if i < n_eval else "train"
        with Image.open(f) as im:
            im.load()
            if im.mode != "RGB":
                im = im.convert("RGB")
            w, h = im.size
            for y0 in range(0, h - size + 1, size):
                for x0 in range(0, w - size + 1, size):
                    im.crop((x0, y0, x0 + size, y0 + size)).save(os.path.join(
                        args.data_dir, split, f"{i:06d}_{y0}_{x0}.png"))
                    count += 1
    logger.info("created %d tiles from %d images", count, len(files))
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("waifu2x", parents=[default_parser],
                              help="waifu2x SR/denoise training")
    p.add_argument("--arch", default="waifu2x.swin_unet_2x")
    p.add_argument("--style", default="art", choices=["art", "photo"])
    p.add_argument("--noise-level", type=int, default=-1,
                   choices=[-1, 0, 1, 2, 3])
    p.add_argument("--size", type=int, default=104)
    p.add_argument("--loss", default=None)
    p.add_argument("--synthetic-p", type=float, default=0.0,
                   help="probability of synthetic screentone/dot/text images")
    p.add_argument("--da-unsharpmask-p", type=float, default=0.0)
    p.add_argument("--da-grayscale-p", type=float, default=0.0)
    p.add_argument("--bicubic-only", action="store_true")
    p.add_argument("--deblur", type=float, default=0)
    p.add_argument("--hard-example", default="linear",
                   choices=["none", "linear", "top10", "top20"],
                   help="hard example mining (reference --hard-example)")
    p.add_argument("--hard-example-scale", type=float, default=4.0)
    p.set_defaults(handler=train_main)
    return p


def register_create_training_data(subparsers, default_parser):
    p = subparsers.add_parser("waifu2x", parents=[default_parser],
                              help="split images into waifu2x training tiles")
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--eval-rate", type=float, default=0.05)
    p.set_defaults(handler=create_training_data_main)
    return p
