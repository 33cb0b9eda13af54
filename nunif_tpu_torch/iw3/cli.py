"""iw3 image CLI, 2D image to stereo 3D (counterpart of the image path of
``nunif_tpu/iw3/cli.py``).

Usage:
  python -m nunif_tpu_torch.iw3.cli -i in.png -o out.png --half-sbs \\
      --depth-checkpoint depth.nztm --stereo-checkpoint row_flow_v3.nztm
  python -m nunif_tpu_torch.iw3.cli -i in.png -o out.png --method mlbw_l2 \\
      --stereo-checkpoint mlbw_l2.nztm
  python -m nunif_tpu_torch.iw3.cli -i in_dir/ -o out_dir/ --seed 0  # random weights

``--stereo-checkpoint`` holds the method's net: row_flow / MLBW, or the
inpaint net of ``forward_inpaint`` / ``mlbw_l2_inpaint`` /
``mlbw_l2_inpaint_video`` (whose mask-MLBW is always seeded, as in the JAX
CLI).  On a still image ``mlbw_l2_inpaint_video`` inpaints the frame as a
clip padded to 12 frames.

Images only: a video input raises ``NotImplementedError``.  ``--device``
defaults to ``cuda`` and fails where CUDA is missing.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from ..core.device import resolve_device
from ..utils import pil_io
from .composition import StereoFormat
from .mapper import MAPPER_ALL

logger = logging.getLogger("nunif_tpu_torch.iw3")

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
VIDEO_EXTS = {".mp4", ".mkv", ".avi", ".webm", ".mov", ".m2ts", ".ts"}
METHODS = ["row_flow_v3", "row_flow_v2", "row_flow_v3_sym",
           "mlbw_l2", "mlbw_l4", "mlbw_l2s", "mlbw_l4s",
           "forward", "forward_fill", "forward_inpaint",
           "mlbw_l2_inpaint", "mlbw_l2_inpaint_video",
           "grid_sample", "backward", "NULL"]
# the stereo net a method builds without a checkpoint
STEREO_MODELS = {"row_flow_v3": "sbs.row_flow_v3",
                 "row_flow_v2": "sbs.row_flow_v2",
                 "row_flow_v3_sym": "sbs.row_flow_v3",
                 "mlbw_l2": "sbs.mlbw_l2", "mlbw_l4": "sbs.mlbw_l4",
                 "mlbw_l2s": "sbs.mlbw_l2s", "mlbw_l4s": "sbs.mlbw_l4s"}


def create_parser():
    p = argparse.ArgumentParser(prog="nunif_tpu_torch.iw3",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input", "-i", required=True, help="input image or directory")
    p.add_argument("--output", "-o", required=True, help="output file or directory")
    p.add_argument("--method", default="row_flow_v3", choices=METHODS)
    p.add_argument("--divergence", "-d", type=float, default=2.0)
    p.add_argument("--convergence", "-c", type=float, default=0.5)
    p.add_argument("--depth-model", default="Any_V2_S")
    p.add_argument("--depth-checkpoint", default=None,
                   help=".nztm checkpoint of the depth model")
    p.add_argument("--stereo-checkpoint", default=None,
                   help=".nztm checkpoint of the method's net (row_flow, "
                        "MLBW, or the inpaint net)")
    p.add_argument("--mapper", default=None, choices=MAPPER_ALL + [None])
    p.add_argument("--foreground-scale", type=float, default=0)
    p.add_argument("--synthetic-view", default="both",
                   choices=["both", "right", "left"])
    p.add_argument("--preserve-screen-border", action="store_true")
    p.add_argument("--resolution", type=int, default=None,
                   help="depth model input resolution (multiple of 14)")
    p.add_argument("--tta", action="store_true")
    p.add_argument("--edge-dilation", type=int, default=None,
                   help="depth edge dilation (default 2)")
    p.add_argument("--half-sbs", action="store_true")
    p.add_argument("--tb", action="store_true")
    p.add_argument("--half-tb", action="store_true")
    p.add_argument("--cross-eyed", action="store_true")
    p.add_argument("--format", default="png", choices=["png", "jpeg", "webp"])
    p.add_argument("--mask-inner-dilation", type=int, default=0,
                   help="inpaint mask inner dilation iterations")
    p.add_argument("--mask-outer-dilation", type=int, default=0,
                   help="inpaint mask outer dilation iterations")
    p.add_argument("--inpaint-max-width", type=int, default=None,
                   help="downscale frames wider than this before inpaint")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda fails where CUDA is missing")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without a checkpoint")
    return p


def build_config(args):
    from .pipeline import StereoConfig
    fmt = StereoFormat(half_sbs=args.half_sbs, tb=args.tb,
                       half_tb=args.half_tb, cross_eyed=args.cross_eyed)
    return StereoConfig(
        method=args.method, divergence=args.divergence,
        convergence=args.convergence, mapper=args.mapper,
        foreground_scale=args.foreground_scale,
        synthetic_view=args.synthetic_view,
        preserve_screen_border=args.preserve_screen_border,
        mask_inner_dilation=args.mask_inner_dilation,
        mask_outer_dilation=args.mask_outer_dilation,
        inpaint_max_width=args.inpaint_max_width, format=fmt)


def _seeded(name, device, seed):
    """Model ``name`` with flax's init drawn from ``seed``, and the JAX
    CLI's warning."""
    from ..models import create_model, init_flax_default
    model = create_model(name)
    init_flax_default(model, torch.Generator().manual_seed(seed))
    logger.warning("%s: no checkpoint given; random init "
                   "(structure/benchmark use only)", name)
    return model.eval().requires_grad_(False).to(device)


def create_stereo_model(method, checkpoint=None, device="cuda", seed=0):
    """The side model of ``method`` (None for the plain warps): the net
    in ``checkpoint``, or flax's init drawn from ``seed``; the inpaint
    methods wrap their inpaint net (and a seeded mask-MLBW)."""
    if method in ("forward", "forward_fill", "grid_sample", "backward", "NULL"):
        return None
    from ..models import load_model
    from . import models  # noqa: F401  (registers the iw3 nets)
    if method in ("forward_inpaint", "mlbw_l2_inpaint", "mlbw_l2_inpaint_video"):
        video = method == "mlbw_l2_inpaint_video"
        if checkpoint:
            net, _meta = load_model(checkpoint, device=device)
        else:
            net = _seeded("inpaint.light_video_inpaint_v1" if video
                          else "inpaint.light_inpaint_v1", device, seed)
        if method == "forward_inpaint":
            from .forward_inpaint import ForwardInpaint
            return ForwardInpaint(net)
        from .mlbw_inpaint import MLBWInpaint, MLBWInpaintVideo
        return (MLBWInpaintVideo if video else MLBWInpaint)(
            net, _seeded("sbs.mask_mlbw_l2", device, seed))
    if checkpoint:
        model, _meta = load_model(checkpoint, device=device)
        return model
    return _seeded(STEREO_MODELS[method], device, seed)


def iter_inputs(input_path):
    if os.path.isdir(input_path):
        for f in sorted(os.listdir(input_path)):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS | VIDEO_EXTS:
                yield os.path.join(input_path, f)
    else:
        yield input_path


def main(argv=None) -> int:
    args = create_parser().parse_args(argv)
    from .depth import create_depth_model
    from .pipeline import process_image

    device = resolve_device(args.device)
    cfg = build_config(args)
    depth_model = create_depth_model(args.depth_model, device=device)
    depth_model.load(resolution=args.resolution,
                     checkpoint=args.depth_checkpoint,
                     generator=torch.Generator().manual_seed(args.seed))
    side_model = create_stereo_model(args.method, args.stereo_checkpoint,
                                     device=device, seed=args.seed)
    edge_dilation = 2 if args.edge_dilation is None else args.edge_dilation

    is_dir_out = os.path.isdir(args.input)
    if is_dir_out:
        os.makedirs(args.output, exist_ok=True)
    n_done = 0
    for src in iter_inputs(args.input):
        if os.path.splitext(src)[1].lower() in VIDEO_EXTS:
            raise NotImplementedError(
                "video input is not ported to nunif_tpu_torch yet "
                "(ROADMAP queue 1)")
        base = os.path.splitext(os.path.basename(src))[0]
        if is_dir_out or os.path.isdir(args.output):
            dst = os.path.join(args.output, base + "." + args.format)
        else:
            dst = args.output
        x, _meta = pil_io.load_image(src)
        x = torch.from_numpy(x[..., :3]).to(device)  # alpha is dropped
        out = process_image(x, cfg, depth_model, side_model, tta=args.tta,
                            edge_dilation=edge_dilation)
        pil_io.save_image(out.float().cpu().numpy(), dst)
        n_done += 1
        logger.info("iw3: %s -> %s", src, dst)
    print(f"processed {n_done} image(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
