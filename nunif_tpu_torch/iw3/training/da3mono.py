"""DA3-mono disparity-conversion training addon and benchmark (counterpart
of ``nunif_tpu/iw3/training/da3mono.py``): ``python -m
nunif_tpu_torch.train da3mono``.

``iw3.da3mono_disparity`` learns the shift of target disparities 1 /
(depth + shift) from synthetic metric-style depth maps, on the min-max
normalised MSE; the eval is the normalised PSNR.  fp32, plain PyTorch.
The maps equal the JAX dataset's but at their nearest point, which JAX
leaves at distance 0 and the port floors at ``MIN_DEPTH``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.device import resolve_device
from ...models import create_model, init_flax_default
from ...training.trainer import (Trainer, TrainerConfig, print_epoch_report,
                                 to_device)
from ..models import da3mono_disparity as _da3  # noqa: F401  (registers the net)


def _normalize(x):
    mn = torch.amin(x, dim=(1, 2, 3), keepdim=True)
    mx = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    return (x - mn) / torch.clamp(mx - mn, min=1e-6)


def normalized_mse(x, y):
    return torch.mean((_normalize(x) - _normalize(y)) ** 2)


def normalized_psnr(x, y):
    mse = torch.mean((_normalize(x) - _normalize(y)) ** 2)
    return -10.0 * torch.log10(1.0 / (mse + 1e-6))


# the nearest synthetic distance: the JAX dataset's maps reach exactly 0
# at their minimum, where 1 / (depth + shift) is infinite while the net's
# ReLU shift is 0 (flax's init at the trainer's default seed): every step
# is then NaN and the JAX trainer never moves
MIN_DEPTH = 0.01


def _synth_depth(rng, size, max_depth=40.0):
    """A metric-style map: a gradient and blobs scaled to a random far
    distance, half of them with a sky at the maximum, floored at
    MIN_DEPTH."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    d = rng.uniform() * xx + rng.uniform() * yy
    for _ in range(rng.integers(1, 5)):
        cx, cy = rng.uniform(), rng.uniform()
        r = rng.uniform(0.1, 0.4)
        d += np.clip(r - np.hypot(xx - cx, yy - cy), 0, None) * 2
    d = (d - d.min()) / max(d.max() - d.min(), 1e-6)
    depth = (d * rng.uniform(2.0, max_depth))[..., None]
    if rng.uniform() < 0.5:  # sky region at max depth
        depth[: size // 4] = depth.max()
    return np.maximum(depth, MIN_DEPTH).astype(np.float32)


class DA3MonoDataset:
    """{"x": depth, "y": 1 / (depth + shift)} batches drawn from
    ``np.random.default_rng(seed)``."""

    def __init__(self, size=128, num_samples=500, seed=71):
        self.size = size
        self.num_samples = num_samples
        self.seed = seed

    def batches(self, batch_size):
        rng = np.random.default_rng(self.seed)
        for _i in range(0, self.num_samples, batch_size):
            xs, ys = [], []
            for _ in range(batch_size):
                depth = _synth_depth(rng, self.size)
                shift = rng.uniform(0.05, 0.5)
                ys.append(1.0 / (depth + shift))
                xs.append(depth)
            yield {"x": np.stack(xs), "y": np.stack(ys)}


def train_main(args):
    device = resolve_device(args.device)
    model = create_model("iw3.da3mono_disparity").to(device)
    init_flax_default(model, torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)

    def loss_fn(model, batch, generator):
        b = to_device(batch, device)
        return normalized_mse(model(b["x"], train=True), b["y"]), {}

    def eval_fn(model, batch):
        b = to_device(batch, device)
        return normalized_psnr(model(b["x"], train=False), b["y"])

    cfg = TrainerConfig(
        model_dir=args.model_dir, max_epoch=args.max_epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        scheduler=args.scheduler, seed=args.seed, resume=args.resume,
        ema_decay=args.ema_decay, checkpoint_name="iw3_da3mono_disparity")
    trainer = Trainer(cfg, model, loss_fn, eval_fn,
                      steps_per_epoch=args.num_samples // args.batch_size)
    train_ds = DA3MonoDataset(size=args.size, num_samples=args.num_samples,
                              seed=args.seed)
    eval_ds = DA3MonoDataset(size=args.size,
                             num_samples=max(args.num_samples // 10,
                                             args.batch_size),
                             seed=args.seed + 1)
    trainer.fit(lambda: train_ds.batches(args.batch_size),
                lambda: eval_ds.batches(args.batch_size),
                on_epoch_end=print_epoch_report)
    return 0


def benchmark_main(checkpoint=None, size=128, n=16, seed=137, device="cuda"):
    """The mean normalised PSNR (dB) of ``checkpoint`` (None: the net at
    flax's initialisation from seed 0) on n synthetic maps."""
    device = resolve_device(device)
    if checkpoint:
        from ...models import load_model
        model, _meta = load_model(checkpoint, device=device)
    else:
        model = create_model("iw3.da3mono_disparity").to(device)
        init_flax_default(model, torch.Generator(device=device).manual_seed(0))
    model.eval()
    ds = DA3MonoDataset(size=size, num_samples=n, seed=seed)
    scores = []
    with torch.no_grad():
        for batch in ds.batches(4):
            b = to_device(batch, device)
            z = model(b["x"], train=False)
            scores.append(float(-normalized_psnr(z, b["y"])))
    return sum(scores) / len(scores)


def register_train(subparsers, default_parser):
    p = subparsers.add_parser("da3mono", parents=[default_parser],
                              help="DA3 depth->disparity head training")
    p.add_argument("--size", type=int, default=128)
    p.set_defaults(handler=train_main)
    return p
