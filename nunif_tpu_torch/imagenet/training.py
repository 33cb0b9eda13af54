"""imagenet training addon (counterpart of
``nunif_tpu/imagenet/training.py``): ``python -m nunif_tpu_torch.train
imagenet``.  Data: ``data_dir/train/<class>/*.png|jpg``, ``data_dir/eval/...``.

The loss is softmax cross-entropy on the integer labels, the eval score
the negative top-1 accuracy.  On the card the training forward runs in
bf16 (fp32 parameters, the trainer's bf16 policy) and the loss is taken
on the fp32 logits; swin_t's window attention is kernel K4, 12 launches a
forward, whose backward is its twin's vector-Jacobian product
(``ops/_build.register_twin_vjp``).  On the CPU it runs fp32, as the JAX
trainer does.

vgg11's ``FrozenBatchNorm`` normalises a training batch by the batch's
statistics and keeps its running ``mean`` / ``var`` as parameters that
the step leaves alone (their gradient is zero and weight decay skips
them); ``calibrate_bn`` recomputes them from training batches before each
evaluation and export.
"""
from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from ..core.device import resolve_device
from ..models import create_model, init_flax_default
from ..training.confusion_matrix import SoftmaxConfusionMatrix  # noqa: F401  (as the JAX module)
from ..training.trainer import (Trainer, TrainerConfig, params_swapped,
                                print_epoch_report, to_device)
from . import models as _models  # noqa: F401  (registers imagenet.*)

logger = logging.getLogger("nunif_tpu_torch.imagenet.training")

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".webp"}


class ImageFolderDataset:
    def __init__(self, root, size=224, training=True, num_samples=None,
                 seed=71):
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise RuntimeError(f"{root}: no class directories")
        self.samples = []
        for ci, cname in enumerate(self.classes):
            cdir = os.path.join(root, cname)
            for f in sorted(os.listdir(cdir)):
                if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS:
                    self.samples.append((os.path.join(cdir, f), ci))
        self.size = size
        self.training = training
        self.num_samples = num_samples or len(self.samples)
        self.rng = random.Random(seed)

    def sample_pair(self, index):
        rng = random.Random(hash((index, self.rng.random() if self.training
                                  else 0)))
        path, label = self.samples[index % len(self.samples)]
        im = Image.open(path)
        im.load()
        if im.mode != "RGB":
            im = im.convert("RGB")
        s = self.size
        w, h = im.size
        if self.training:
            scale = rng.uniform(0.7, 1.0)
            cw = max(s // 2, int(min(w, h) * scale))
            x0 = rng.randint(0, max(0, w - cw))
            y0 = rng.randint(0, max(0, h - cw))
            im = im.crop((x0, y0, x0 + cw, y0 + cw)).resize((s, s),
                                                            Image.BILINEAR)
            if rng.random() < 0.5:
                im = im.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        else:
            m = min(w, h)
            im = im.crop(((w - m) // 2, (h - m) // 2,
                          (w + m) // 2, (h + m) // 2)).resize(
                (s, s), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0, label

    def batches(self, batch_size):
        n = (self.num_samples // batch_size) * batch_size
        order = list(range(n))
        if self.training:
            self.rng.shuffle(order)
        for start in range(0, n, batch_size):
            xs, ys = zip(*(self.sample_pair(i)
                           for i in order[start:start + batch_size]))
            yield {"x": np.stack(xs), "y": np.asarray(ys, np.int32)}


def bn_names(model) -> list:
    """The FrozenBatchNorm modules' names (``bn0`` ...), sorted."""
    return sorted(n for n, m in model.named_children() if n.startswith("bn"))


def calibrate_bn(model, params, batches, max_batches: int = 64,
                 dtype=torch.float32) -> dict:
    """{name: tensor} ``params`` with each ``bn{k}.mean`` / ``bn{k}.var``
    recomputed over up to ``max_batches`` of ``batches``: the statistics of
    ``conv{k}``'s output (the BN's input, taken by a forward pre-hook) in a
    ``train=True`` forward of x in ``dtype`` under ``params``, so earlier
    layers normalise by the batch statistics as in the training forward.
    Sums in float64, the variance clamped at 0, stored fp32."""
    names = bn_names(model)
    if not names:
        return params
    device = next(model.parameters()).device
    sums, sqs, count = {}, {}, dict.fromkeys(names, 0)

    def tap(name):
        def hook(_module, inputs):
            v = inputs[0].detach().to(torch.float64)
            flat = v.reshape(-1, v.shape[-1])
            s, q = flat.sum(0), (flat * flat).sum(0)
            sums[name] = s if name not in sums else sums[name] + s
            sqs[name] = q if name not in sqs else sqs[name] + q
            count[name] += flat.shape[0]
        return hook

    hooks = [getattr(model, n).register_forward_pre_hook(tap(n)) for n in names]
    try:
        with torch.no_grad(), params_swapped(model, params):
            for seen, batch in enumerate(batches, 1):
                x = batch["x"] if isinstance(batch, dict) else batch
                x = torch.as_tensor(np.ascontiguousarray(x)).to(device, dtype)
                model(x, train=True)
                if seen >= max_batches:
                    break
    finally:
        for h in hooks:
            h.remove()
    out = dict(params)
    for n in names:
        mean = sums[n] / count[n]
        var = sqs[n] / count[n] - mean * mean
        out[f"{n}.mean"] = mean.float()
        out[f"{n}.var"] = var.clamp_min(0).float()
    return out


def train_main(args):
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    train_ds = ImageFolderDataset(os.path.join(args.data_dir, "train"),
                                  size=args.size, num_samples=args.num_samples)
    eval_ds = ImageFolderDataset(os.path.join(args.data_dir, "eval"),
                                 size=args.size, training=False)
    model = create_model(args.arch, num_classes=len(train_ds.classes)).to(device)
    init_flax_default(model, torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    dtypes = {"x": compute_dtype, "y": torch.long}

    def loss_fn(model, batch, generator):
        b = to_device(batch, device, dtypes)
        logits = model(b["x"], train=True).float()
        return F.cross_entropy(logits, b["y"]), {}

    def eval_fn(model, batch):
        b = to_device(batch, device, dtypes)
        logits = model(b["x"], train=False).float()
        # negative accuracy: best is the minimum
        return -torch.mean((logits.argmax(-1) == b["y"]).float())

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, scheduler=args.scheduler,
        seed=args.seed, resume=args.resume,
        checkpoint_name=args.arch.replace(".", "_"))
    eval_params_fn = None
    if bn_names(model):
        def eval_params_fn(p):
            return calibrate_bn(model, p, train_ds.batches(args.batch_size),
                                max_batches=16, dtype=compute_dtype)
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size,
                      eval_params_fn=eval_params_fn)
    logger.info("imagenet: %s, %d classes, size %d, %s on %s", args.arch,
                len(train_ds.classes), args.size, compute_dtype, device)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("imagenet", parents=[default_parser],
                              help="imagenet classifier training")
    p.add_argument("--arch", default="imagenet.vgg11",
                   choices=["imagenet.vgg11", "imagenet.swin_t"])
    p.add_argument("--size", type=int, default=224)
    p.set_defaults(handler=train_main)
    return p
