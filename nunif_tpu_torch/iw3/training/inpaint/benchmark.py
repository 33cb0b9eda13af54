"""Inpaint model quality over an eval set: PSNR on the hole's pixels and,
optionally, LPIPS (counterpart of
``nunif_tpu/iw3/training/inpaint/benchmark.py``).

    python -m nunif_tpu_torch.iw3.training.inpaint.benchmark \
        --checkpoint-file m.nztm [--data-dir d] [--video] [--lpips] [--device cpu]

The image (``InpaintDataset``) or video (``VideoInpaintDataset``) eval
split, the net given the hole-masked image, only the hole's pixels taken
from its output; the mean of the per-sample masked PSNR.  Without a
checkpoint the net is flax's initialisation from seed 0 (a warning); the
LPIPS trunk is seeded random (no VGG weights in the repository).  fp32, on
the card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from ....core.device import resolve_device
from .dataset import InpaintDataset, VideoInpaintDataset

logger = logging.getLogger("nunif_tpu_torch.iw3.training.inpaint")


def masked_psnr(pred, target, mask):
    """Per-sample PSNR over the masked (hole) pixels only."""
    pred = pred.clamp(0.0, 1.0)
    target = target.clamp(0.0, 1.0)
    mask = torch.broadcast_to(mask, pred.shape).float()
    dims = tuple(range(1, pred.dim()))
    se = ((pred - target) ** 2 * mask).sum(dim=dims)
    mse = se / torch.clamp(mask.sum(dim=dims), min=1.0)
    return 10.0 * torch.log10(1.0 / (mse + 1e-6))


def benchmark_main(checkpoint=None, data_dir=None, video=False, size=128,
                   num_samples=64, batch_size=8, lpips=False, seed=71,
                   device="cuda"):
    from ....models import create_model, init_flax_default, load_model
    device = resolve_device(device)
    if checkpoint:
        model, _meta = load_model(checkpoint, device=device)
    else:
        from ... import models as _m  # noqa: F401  (registers the nets)
        name = ("inpaint.light_video_inpaint_v1" if video
                else "inpaint.light_inpaint_v1")
        model = create_model(name)
        init_flax_default(model, torch.Generator().manual_seed(0))
        model.to(device).eval().requires_grad_(False)
        logger.warning("inpaint benchmark: seeded random %s "
                       "(no --checkpoint-file)", name)
    if video:
        ds = VideoInpaintDataset(data_dir, size=size,
                                 num_samples=max(num_samples // 8, 4),
                                 seed=seed, training=False)
    else:
        ds = InpaintDataset(data_dir, size=size, num_samples=num_samples,
                            seed=seed, training=False)
    lpips_model = None
    if lpips:
        from ....modules.lpips import LPIPS
        lpips_model = LPIPS()
        init_flax_default(lpips_model, torch.Generator().manual_seed(0))
        lpips_model.to(device).eval().requires_grad_(False)

    psnrs, lpipss = [], []
    with torch.no_grad():
        for batch in ds.batches(batch_size):
            y = torch.from_numpy(np.ascontiguousarray(batch["y"])).to(device).float()
            mask = torch.from_numpy(np.ascontiguousarray(batch["mask"])).to(device).float()
            if mask.dim() == y.dim() - 1:
                mask = mask[..., None]
            x = y * (1.0 - mask)
            pred = model(x, mask=mask, train=False)
            if isinstance(pred, tuple):
                pred = pred[0]
            comp = y * (1.0 - mask) + pred * mask  # the hole from the net
            psnrs.append(masked_psnr(comp, y, mask).cpu().numpy())
            if lpips_model is not None:
                flat_c = comp.reshape((-1,) + tuple(comp.shape[-3:]))
                flat_y = y.reshape((-1,) + tuple(y.shape[-3:]))
                lpipss.append(float(lpips_model(flat_c, flat_y, normalize=True).mean()))
    result = {"masked_psnr": float(np.concatenate([p.reshape(-1) for p in psnrs]).mean())}
    if lpipss:
        result["lpips"] = float(np.mean(lpipss))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data-dir", "-i", default=None,
                   help="eval image dir (synthetic images when omitted)")
    p.add_argument("--checkpoint-file", default=None)
    p.add_argument("--video", action="store_true")
    p.add_argument("--lpips", action="store_true")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--num-samples", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    r = benchmark_main(checkpoint=args.checkpoint_file, data_dir=args.data_dir,
                       video=args.video, size=args.size,
                       num_samples=args.num_samples, batch_size=args.batch_size,
                       lpips=args.lpips, device=args.device)
    for k, v in r.items():
        print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
