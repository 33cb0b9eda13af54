"""Sweep the mask-MLBW hole-mask threshold against the forward warp's
hole masks (counterpart of
``nunif_tpu/iw3/training/sbs/find_mask_threshold.py``): for each rgb +
depth pair, the hole mask of the depth-ordered forward warp (both eyes,
closed once) and the ``sbs.mask_mlbw_*`` model's thresholded mask
(``postprocess_hole_mask``), their mean IoU a threshold; ``--visualize-dir``
writes the two masks side by side.

    python -m nunif_tpu_torch.iw3.training.sbs.find_mask_threshold \\
        --rgb-dir rgb/ --depth-dir depth/ --checkpoint-file mask_mlbw.nztm

The model's mask is the port's ``postprocess_hole_mask``, which closes
the thresholded mask; the JAX function closes the logits (ROADMAP's
settled divergences).  The JAX sweep feeds the net the 8-channel
training input and raises there; the port feeds it the inference input.
Runs on ``--device`` (the card by default).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ....core.device import resolve_device
from ....modules.jaccard import jaccard_index
from ....utils.image_loader import list_images
from ....utils.pil_io import load_image, save_image
from ...backward_warp import make_input_tensor, postprocess_hole_mask
from ...dilation import mask_closing
from ...forward_warp import depth_order_bilinear_forward_warp

THRESHOLDS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7)


def forward_nonwarp_mask(rgb, depth, divergence=2.0, convergence=0.5):
    """The holes of the depth-ordered forward warp of both eyes, (B, H,
    W, 1) in {0, 1}, closed once."""
    _l, _r, left_mask, right_mask = depth_order_bilinear_forward_warp(
        rgb, depth, divergence, convergence, fill=False, return_mask=True)
    m = torch.maximum(left_mask.float(), right_mask.float())
    return mask_closing((m > 0.9).float(), n_iter=1)


def model_hole_mask(model, rgb, depth, divergence=2.0, convergence=0.5,
                    threshold=0.4):
    """The thresholded hole mask of a ``sbs.mask_mlbw_*`` model at rgb's
    size.  The net takes the 3-channel [depth, divergence, convergence]
    input, as on the inference path; the JAX function passes the 8-channel
    training input with rgb, which the net's first convolution refuses."""
    _B, H, W, _ = rgb.shape
    x = make_input_tensor(None, depth, divergence, convergence, W)
    out = model(x, train=False)
    assert isinstance(out, (tuple, list)) and len(out) >= 3, \
        "checkpoint is not a hole-mask model (sbs.mask_mlbw_*)"
    return postprocess_hole_mask(out[2], (H, W), threshold)


@torch.no_grad()
def sweep(rgb_dir, depth_dir, checkpoint, divergence=2.0,
          thresholds=THRESHOLDS, visualize_dir=None, limit=None,
          device="cuda"):
    """{threshold: mean IoU} over the pairs of the two directories."""
    from ....models import load_model
    rgb_files = list_images(rgb_dir)
    depth_files = list_images(depth_dir)
    if len(rgb_files) != len(depth_files) or not rgb_files:
        raise ValueError(
            f"rgb/depth mismatch: {len(rgb_files)} vs {len(depth_files)}")
    if limit:
        rgb_files, depth_files = rgb_files[:limit], depth_files[:limit]
    device = resolve_device(device)
    model, _meta = load_model(checkpoint, device=device)

    results = {t: [] for t in thresholds}
    for i, (rf, df) in enumerate(zip(rgb_files, depth_files)):
        rgb, _m1 = load_image(rf)
        dep, _m2 = load_image(df, color="gray")
        rgb = torch.from_numpy(np.ascontiguousarray(rgb[None, ..., :3])).to(device)
        dep = torch.from_numpy(np.ascontiguousarray(dep[None, ..., :1])).to(device)
        gt = forward_nonwarp_mask(rgb, dep, divergence)
        for t in thresholds:
            pred = model_hole_mask(model, rgb, dep, divergence, threshold=t)
            results[t].append(jaccard_index(pred, gt))
            if visualize_dir and t == thresholds[len(thresholds) // 2]:
                os.makedirs(visualize_dir, exist_ok=True)
                vis = torch.cat([gt[0], pred[0]], dim=1).cpu().numpy()
                save_image(np.repeat(vis, 3, axis=-1),
                           os.path.join(visualize_dir, f"mask_{i:04d}.png"))
    return {t: float(np.mean(v)) for t, v in results.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--rgb-dir", required=True)
    p.add_argument("--depth-dir", required=True)
    p.add_argument("--checkpoint-file", required=True)
    p.add_argument("--divergence", type=float, default=2.0)
    p.add_argument("--visualize-dir", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    scores = sweep(args.rgb_dir, args.depth_dir, args.checkpoint_file,
                   divergence=args.divergence,
                   visualize_dir=args.visualize_dir, limit=args.limit,
                   device=args.device)
    best = max(scores, key=scores.get)
    for t, s in sorted(scores.items()):
        mark = " <-- best" if t == best else ""
        print(f"threshold={t:.2f} IOU={s:.4f}{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
