"""iw3 image CLI, 2D image to stereo 3D (counterpart of the image path of
``nunif_tpu/iw3/cli.py``, with every flag of its parser).

Usage:
  python -m nunif_tpu_torch.iw3.cli -i in.png -o out.png --half-sbs \\
      --depth-checkpoint depth.nztm --stereo-checkpoint row_flow_v3.nztm
  python -m nunif_tpu_torch.iw3.cli -i in.png -o out.png --method mlbw_l2 \\
      --stereo-checkpoint mlbw_l2.nztm
  python -m nunif_tpu_torch.iw3.cli -i in_dir/ -o out_dir/ --seed 0  # random weights
  python -m nunif_tpu_torch.iw3.cli -i in.png -o out.png --anaglyph dubois --depth-aa
  python -m nunif_tpu_torch.iw3.cli -i in.png -o out.png --vr180 \\
      --convergence-mode sod_v1 --sod-checkpoint sod_v1.nztm
  python -m nunif_tpu_torch.iw3.cli -i in.png -o export_dir/ --export
  python -m nunif_tpu_torch.iw3.cli -i export_dir/iw3_export.yml -o out_dir/

``--stereo-checkpoint`` holds the method's net: row_flow / MLBW, or the
inpaint net of ``forward_inpaint`` / ``mlbw_l2_inpaint`` /
``mlbw_l2_inpaint_video`` (whose mask-MLBW is always seeded, as in the JAX
CLI).  On a still image ``mlbw_l2_inpaint_video`` inpaints the frame as a
clip padded to 12 frames.  ``--depth-aa-checkpoint`` / ``--sod-checkpoint``
take a ``.nztm`` or a raw upstream ``.pth`` / ``.pt`` / ``.safetensors``
(BatchNorm folded into U2NETP's convs); without one each net is flax's
init drawn from ``--seed``.

``--export`` (or ``--export-disparity``) writes ``rgb/``, 16-bit
``depth/`` and ``iw3_export.yml`` into the output folder; an input ending
in ``.yml`` renders from such a folder.  The export infers depth with the
edge dilation the render uses (2 unless ``--edge-dilation`` says
otherwise), where the JAX CLI exports with none.  Unlike the JAX CLI, the
image path honours ``--debug-depth`` and ``--convergence-mode sod_v1``
(each image on its own: the estimator's EMA is off).

A video input (by its extension; a directory may mix images and videos)
runs through ``video.process_video_full`` with the video flags of the JAX
parser: ``--metadata filename`` names the output after the method,
divergence and convergence; ``--resume`` skips an existing output and
``--yes`` overwrites it; ``--skip-error`` writes ``<out>.error.flag`` on a
failure, goes on, and skips a flagged output later;
``--scene-detect-only`` prints a video's scene boundaries (cached) and
writes nothing.  ``--export`` takes images only.  ``--devices`` above 1
raises ``NotImplementedError`` (ROADMAP queue 1, multi-device).  ``--device``
defaults to ``cuda`` and fails where CUDA is missing.

    python -m nunif_tpu_torch.iw3.cli -i in.mp4 -o out.mp4 --half-sbs --yes
    python -m nunif_tpu_torch.iw3.cli -i in.mp4 -o out.mp4 --depth-model \\
        VDA_Stream_S --method mlbw_l2_inpaint_video --scene-detect --autocrop
"""
from __future__ import annotations

import argparse
import datetime
import logging
import os
import sys

import torch

from ..core.device import resolve_device
from ..utils import pil_io
from .anaglyph import ANAGLYPH_TYPES
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
DEFAULT_EDGE_DILATION = 2  # for render and export alike


def create_parser():
    p = argparse.ArgumentParser(prog="nunif_tpu_torch.iw3",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input", "-i", required=True,
                   help="input image or directory, or an iw3_export.yml")
    p.add_argument("--output", "-o", required=True, help="output file or directory")
    p.add_argument("--method", default="row_flow_v3", choices=METHODS)
    p.add_argument("--divergence", "-d", type=float, default=2.0)
    p.add_argument("--convergence", "-c", type=float, default=0.5)
    p.add_argument("--depth-model", default="Any_V2_S",
                   help="depth model type (nunif_tpu_torch.iw3.depth."
                        "DEPTH_MODEL_TYPES: Depth-Anything, NULL, VDA, ZoeD_*, "
                        "DepthPro / DepthPro_S, Any_V3_Mono / Any_V3_Mono_01)")
    p.add_argument("--depth-checkpoint", default=None,
                   help="depth model weights: a .nztm file, or a raw upstream "
                        ".pth / .pt / .safetensors (Depth-Anything, DepthPro, "
                        "DA3), by suffix")
    p.add_argument("--stereo-checkpoint", default=None,
                   help=".nztm checkpoint of the method's net (row_flow, "
                        "MLBW, or the inpaint net)")
    p.add_argument("--mapper", default=None, choices=MAPPER_ALL + [None])
    p.add_argument("--foreground-scale", type=float, default=0)
    p.add_argument("--synthetic-view", default="both",
                   choices=["both", "right", "left"])
    p.add_argument("--preserve-screen-border", action="store_true")
    p.add_argument("--resolution", type=int, default=None,
                   help="depth model input resolution, rounded up to a "
                        "multiple of 32 for ZoeD_N / K / NK and of 14 for the "
                        "others; DepthPro ignores it")
    p.add_argument("--tta", action="store_true")
    p.add_argument("--edge-dilation", type=int, default=None,
                   help=f"depth edge dilation (default {DEFAULT_EDGE_DILATION}, "
                        "for the render and the export)")
    p.add_argument("--rotate-left", action="store_true")
    p.add_argument("--rotate-right", action="store_true")
    p.add_argument("--max-output-width", type=int, default=None)
    p.add_argument("--max-output-height", type=int, default=None)
    p.add_argument("--keep-aspect-ratio", action="store_true")
    # output formats
    p.add_argument("--half-sbs", action="store_true")
    p.add_argument("--tb", action="store_true")
    p.add_argument("--half-tb", action="store_true")
    p.add_argument("--cross-eyed", action="store_true")
    p.add_argument("--anaglyph", default=None, choices=ANAGLYPH_TYPES)
    p.add_argument("--vr180", action="store_true")
    p.add_argument("--rgbd", action="store_true")
    p.add_argument("--half-rgbd", action="store_true")
    p.add_argument("--pad", type=float, default=None)
    p.add_argument("--pad-mode", default="tblr",
                   choices=["tblr", "tb", "lr", "16:9", "top"])
    p.add_argument("--ipd-offset", type=float, default=0.0)
    p.add_argument("--resume", action="store_true",
                   help="skip existing output files")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--format", default="png", choices=["png", "jpeg", "webp"])
    # video options, with the JAX parser's defaults
    p.add_argument("--video-codec", default="libx264")
    p.add_argument("--crf", type=int, default=20)
    p.add_argument("--preset", default="ultrafast")
    p.add_argument("--pix-fmt", default="yuv420p",
                   choices=["yuv420p", "yuv444p", "yuv420p10le", "rgb24",
                            "gbrp", "gbrp10le", "gbrp16le"])
    p.add_argument("--max-fps", type=float, default=30.0)
    p.add_argument("--video-batch", type=int, default=4)
    p.add_argument("--devices", type=int, default=1,
                   help="devices to shard video batches over (above 1 is not "
                        "ported)")
    p.add_argument("--ema-normalize", action="store_true",
                   help="EMA min-max depth normalization for video")
    p.add_argument("--ema-decay", type=float, default=0.75)
    p.add_argument("--ema-buffer", type=int, default=30)
    p.add_argument("--scene-detect", action="store_true",
                   help="flush the temporal depth state at scene cuts (video)")
    p.add_argument("--scene-detect-threshold", type=float, default=0.3)
    p.add_argument("--scene-min-frames", type=int, default=10)
    p.add_argument("--scene-detect-checkpoint", default=None,
                   help="TransNetV2 checkpoint for --scene-detect")
    p.add_argument("--autocrop", action="store_true",
                   help="crop letterbox bars before conversion (video)")
    p.add_argument("--autocrop-mode", default="black",
                   choices=["black", "black_tb", "black_lr",
                            "flat", "flat_tb", "flat_lr"])
    p.add_argument("--skip-error", action="store_true",
                   help="on a video error write <out>.error.flag and go on")
    p.add_argument("--start-time", type=float, default=None,
                   help="video trim start (seconds)")
    p.add_argument("--end-time", type=float, default=None,
                   help="video trim end (seconds)")
    p.add_argument("--video-format", "-vf", default="mp4",
                   choices=["mp4", "mkv", "avi"],
                   help="container for video outputs of a directory")
    p.add_argument("--video-bitrate", default=None,
                   help="target bitrate, e.g. 8M")
    p.add_argument("--tune", nargs="+", default=[],
                   help="encoder tune option(s), e.g. film animation")
    p.add_argument("--profile-level", default=None, help="h264 profile level")
    p.add_argument("--keyframe-interval", type=float, default=None,
                   help="keyframe interval in seconds")
    p.add_argument("--colorspace", default="auto",
                   choices=["auto", "unspecified", "copy",
                            "bt709", "bt709-pc", "bt709-tv",
                            "bt601", "bt601-pc", "bt601-tv"])
    p.add_argument("--metadata", nargs="?", const="filename", default=None,
                   choices=["filename"],
                   help="embed the conversion parameters in the video's "
                        "output filename")
    p.add_argument("--yes", "-y", action="store_true",
                   help="overwrite existing video outputs")
    p.add_argument("--stereo-width", type=int, default=None,
                   help="processing width of the row_flow / MLBW nets")
    p.add_argument("--warp-steps", type=int, default=None,
                   help="forward-warp step count override")
    p.add_argument("--mask-inner-dilation", type=int, default=0,
                   help="inpaint mask inner dilation iterations")
    p.add_argument("--mask-outer-dilation", type=int, default=0,
                   help="inpaint mask outer dilation iterations")
    p.add_argument("--inpaint-max-width", type=int, default=None,
                   help="downscale frames wider than this before inpaint")
    p.add_argument("--limit-resolution", action="store_true",
                   help="cap the depth resolution at the source resolution")
    p.add_argument("--batch-size", type=int, default=None,
                   help="video depth batch size (alias of --video-batch)")
    p.add_argument("--max-workers", type=int, default=None,
                   help="accepted for compatibility; unused")
    p.add_argument("--disable-scene-cache", action="store_true",
                   help="re-run scene detection even when cached")
    p.add_argument("--scene-cache-dir", default=None,
                   help="directory of scene-boundary caches")
    p.add_argument("--scene-detect-only", action="store_true",
                   help="run the scene-detection pass of a video and exit")
    p.add_argument("--debug-depth", action="store_true",
                   help="output the normalized depth instead of stereo")
    p.add_argument("--convergence-mode", default="constant",
                   choices=["constant", "sod_v1"],
                   help="sod_v1: saliency-driven per-frame convergence")
    p.add_argument("--sod-checkpoint", default=None,
                   help="iw3.sod_v1 checkpoint (.nztm, or a raw .pth / .pt / "
                        ".safetensors) for --convergence-mode sod_v1")
    p.add_argument("--depth-aa", action="store_true",
                   help="apply the DepthAA anti-aliasing net to depth maps")
    p.add_argument("--depth-aa-checkpoint", default=None,
                   help="iw3.depth_aa checkpoint (.nztm, or a raw .pth / .pt / "
                        ".safetensors)")
    p.add_argument("--export-disparity", action="store_true",
                   help="export the mapper-applied disparity instead of "
                        "raw depth (implies --export)")
    p.add_argument("--export-depth-only", action="store_true",
                   help="omit the rgb image from exports")
    p.add_argument("--export", action="store_true",
                   help="export RGB + 16-bit depth + iw3_export.yml instead "
                        "of rendering (input a .yml to re-import)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda fails where CUDA is missing")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without a checkpoint")
    return p


def build_config(args):
    from .pipeline import StereoConfig
    fmt = StereoFormat(
        half_sbs=args.half_sbs, tb=args.tb, half_tb=args.half_tb,
        cross_eyed=args.cross_eyed, anaglyph=args.anaglyph, vr180=args.vr180,
        rgbd=args.rgbd, half_rgbd=args.half_rgbd, pad=args.pad,
        pad_mode=args.pad_mode, ipd_offset=args.ipd_offset,
        max_output_width=args.max_output_width,
        max_output_height=args.max_output_height,
        keep_aspect_ratio=args.keep_aspect_ratio)
    return StereoConfig(
        method=args.method, divergence=args.divergence,
        convergence=args.convergence, mapper=args.mapper,
        foreground_scale=args.foreground_scale,
        synthetic_view=args.synthetic_view,
        preserve_screen_border=args.preserve_screen_border,
        rotate_left=args.rotate_left, rotate_right=args.rotate_right,
        max_output_width=args.max_output_width,
        max_output_height=args.max_output_height,
        keep_aspect_ratio=args.keep_aspect_ratio, format=fmt,
        stereo_width=args.stereo_width, warp_steps=args.warp_steps,
        mask_inner_dilation=args.mask_inner_dilation,
        mask_outer_dilation=args.mask_outer_dilation,
        inpaint_max_width=args.inpaint_max_width)


def _seeded(name, device, seed):
    """Model ``name`` with flax's init drawn from ``seed`` on ``device``,
    and the JAX CLI's warning."""
    from ..models import create_model, init_flax_default
    with torch.device(device):
        model = create_model(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    if hasattr(model, "init_flax_default_"):
        model.init_flax_default_(gen)
    else:
        init_flax_default(model, gen)
    logger.warning("%s: no checkpoint given; random init "
                   "(structure/benchmark use only)", name)
    return model.eval().requires_grad_(False).to(device)


def _net(name, checkpoint, device, seed):
    """The registered net ``name`` (``iw3.depth_aa``, ``iw3.sod_v1``): from
    a ``.nztm`` checkpoint, which must hold one, or a raw upstream ``.pth``
    / ``.pt`` / ``.safetensors`` state dict (bare or in a nunif envelope
    that names it or an alias of it), converted by the ``.pth`` importer's
    row, or seeded."""
    from ..models import load_model
    from ..models.pth_import import (canonical_name, convert_torch_state,
                                     is_raw_checkpoint, load_torch_checkpoint)
    from . import models  # noqa: F401  (registers the iw3 nets)
    if not checkpoint:
        return _seeded(name, device, seed)
    if is_raw_checkpoint(checkpoint):
        named, kwargs, sd = load_torch_checkpoint(checkpoint)
        if named is not None and canonical_name(named) != name:
            raise ValueError(f"{checkpoint}: a {named} checkpoint, not {name}")
        model = convert_torch_state(name, kwargs, sd)
        return model.eval().requires_grad_(False).to(device)
    model, _meta = load_model(checkpoint, device=device)
    if getattr(model, "model_name", None) != name:
        raise ValueError(f"{checkpoint}: not an {name} checkpoint "
                         f"({type(model).__name__})")
    return model


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


def create_convergence_estimator(args, cfg, device):
    """``--convergence-mode sod_v1``: a ConvergenceEstimator on the
    ``iw3.sod_v1`` net of ``--sod-checkpoint`` (or seeded), its EMA off
    (each image stands alone); else None."""
    if args.convergence_mode != "sod_v1":
        return None
    from .convergence_estimator import ConvergenceEstimator
    return ConvergenceEstimator(
        cfg.convergence, _net("iw3.sod_v1", args.sod_checkpoint, device, args.seed))


def iter_inputs(input_path, recursive=False):
    exts = IMAGE_EXTS | VIDEO_EXTS
    if not os.path.isdir(input_path):
        yield input_path
        return
    if recursive:
        for root, _dirs, files in sorted(os.walk(input_path)):
            for f in sorted(files):
                if os.path.splitext(f)[1].lower() in exts:
                    yield os.path.join(root, f)
    else:
        for f in sorted(os.listdir(input_path)):
            if os.path.splitext(f)[1].lower() in exts:
                yield os.path.join(input_path, f)


def _load_rgb(path, device):
    x, _meta = pil_io.load_image(path)
    return torch.from_numpy(x[..., :3]).to(device)  # alpha is dropped


def export_main(args, cfg, depth_model, edge_dilation, device) -> int:
    """``--export``: each input's (preprocessed) RGB as an 8-bit PNG, its
    min-max normalised depth (or, with ``--export-disparity``, the
    mapper-applied disparity) as a 16-bit PNG, and ``iw3_export.yml``."""
    from .depth.base import BaseDepthModel
    from .export_config import DEPTH_DIR, FILENAME, IMAGE_TYPE, RGB_DIR, ExportConfig
    from .mapper import get_mapper
    from .pipeline import preprocess_image
    rgb_dir = os.path.join(args.output, RGB_DIR)
    depth_dir = os.path.join(args.output, DEPTH_DIR)
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)
    export_disparity = args.export_disparity
    mapper = cfg.resolved_mapper(depth_model.is_metric())
    n = 0
    for src in iter_inputs(args.input, args.recursive):
        if os.path.splitext(src)[1].lower() in VIDEO_EXTS:
            raise ValueError(f"--export takes images; {src} is a video")
        with torch.no_grad():
            x = preprocess_image(_load_rgb(src, device)[None], cfg)
            d = depth_model.infer(x, tta=args.tta, edge_dilation=edge_dilation)[0]
        dmin, dmax = float(d.min()), float(d.max())
        dn = (d - dmin) / max(dmax - dmin, 1e-6)
        if export_disparity:
            dn = get_mapper(mapper)(dn)
            dmin, dmax = 0.0, 1.0
        base = os.path.splitext(os.path.basename(src))[0]
        if not args.export_depth_only:
            pil_io.save_image(x[0].float().cpu().numpy(),
                              os.path.join(rgb_dir, base + ".png"))
        BaseDepthModel.save_normalized_depth(
            dn, os.path.join(depth_dir, base + ".png"),
            min_depth_value=dmin, max_depth_value=dmax)
        n += 1
    ExportConfig(IMAGE_TYPE, basename=os.path.basename(args.input),
                 mapper="none" if export_disparity else mapper,
                 skip_mapper=export_disparity,
                 divergence=args.divergence, convergence=args.convergence,
                 updated_at=datetime.datetime.now().isoformat()).save(
        os.path.join(args.output, FILENAME))
    print(f"exported {n} image(s)", file=sys.stderr)
    return 0


def import_main(args, cfg, device) -> int:
    """Render every image of an export folder (input: its
    ``iw3_export.yml``) with its stored depth, renormalised."""
    from .depth.base import BaseDepthModel
    from .export_config import ExportConfig
    from .pipeline import stereo_from_depth
    base_dir = os.path.dirname(os.path.abspath(args.input))
    ecfg = ExportConfig.load(args.input)
    rgb_dir, depth_dir = ecfg.resolve_paths(base_dir)
    if ecfg.mapper and args.mapper is None:
        cfg.mapper = "none" if ecfg.skip_mapper else ecfg.mapper
    side_model = create_stereo_model(args.method, args.stereo_checkpoint,
                                     device=device, seed=args.seed)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(rgb_dir)):
        base, ext = os.path.splitext(f)
        if ext.lower() not in IMAGE_EXTS:
            continue
        x = _load_rgb(os.path.join(rgb_dir, f), device)[None]
        d, _meta = BaseDepthModel.load_depth(os.path.join(depth_dir, base + ".png"))
        d = d[None].to(device)
        dmin, dmax = float(d.min()), float(d.max())
        with torch.no_grad():
            out = stereo_from_depth(x, (d - dmin) / max(dmax - dmin, 1e-6),
                                    cfg, side_model)
        pil_io.save_image(out[0].float().cpu().numpy(),
                          os.path.join(args.output, base + "." + args.format))
        n += 1
    print(f"imported {n} image(s)", file=sys.stderr)
    return 0


def video_output_path(args, dst):
    """``dst``, or with ``--metadata filename`` the method, divergence and
    convergence added to its name."""
    if args.metadata != "filename":
        return dst
    base, ext = os.path.splitext(dst)
    return f"{base}_{args.method}_d{args.divergence:g}_c{args.convergence:g}{ext}"


def run_video(args, cfg, depth_model, side_model, edge_dilation, device,
              src, dst) -> bool:
    """One video with the resume / overwrite / error-flag rules; True when
    it was converted (or skipped as done)."""
    from ..video import engine
    from .video import process_video_full
    dst = video_output_path(args, dst)
    if args.resume and os.path.exists(dst):
        logger.info("skip (exists): %s", dst)
        return True
    if os.path.exists(dst) and not args.yes:
        logger.warning("output exists (use --yes to overwrite or --resume to "
                       "skip silently): %s", dst)
        return False
    if args.skip_error and engine.has_error_flag(dst):
        logger.info("skip (error flag): %s", dst)
        return False
    if args.scene_detect_only:
        from .scene_boundary_cache import detect_boundaries_cached
        b = detect_boundaries_cached(
            src, max_fps=args.max_fps, threshold=args.scene_detect_threshold,
            min_frames=args.scene_min_frames,
            checkpoint=args.scene_detect_checkpoint,
            cache_dir=args.scene_cache_dir, device=device)
        print(f"{src}: {len(b)} scene boundaries: {sorted(b)[:50]}",
              file=sys.stderr)
        return True
    vc = engine.VideoOutputConfig(
        codec=args.video_codec, crf=args.crf, preset=args.preset,
        pix_fmt=args.pix_fmt, max_fps=args.max_fps, bitrate=args.video_bitrate,
        tune=tuple(args.tune), profile_level=args.profile_level,
        keyframe_interval=args.keyframe_interval, colorspace=args.colorspace)
    sod_model = None
    if args.convergence_mode == "sod_v1":
        sod_model = _net("iw3.sod_v1", args.sod_checkpoint, device, args.seed)
    try:
        process_video_full(
            src, dst, cfg, depth_model, side_model, tta=args.tta,
            edge_dilation=edge_dilation, batch_size=args.video_batch,
            video_config=vc, ema_normalize=args.ema_normalize,
            ema_decay=args.ema_decay, ema_buffer=args.ema_buffer,
            scene_detect=args.scene_detect,
            scene_detect_threshold=args.scene_detect_threshold,
            scene_min_frames=args.scene_min_frames,
            scene_detect_checkpoint=args.scene_detect_checkpoint,
            scene_cache_dir=args.scene_cache_dir,
            scene_cache_disable=args.disable_scene_cache,
            autocrop=args.autocrop, autocrop_mode=args.autocrop_mode,
            start_time=args.start_time, end_time=args.end_time,
            debug_depth=args.debug_depth,
            convergence_mode=args.convergence_mode, sod_model=sod_model)
    except Exception as e:
        if not args.skip_error:
            raise
        logger.error("error processing %s: %s", src, e)
        engine.write_error_flag(dst, e)
        return False
    engine.clear_error_flag(dst)
    return True


def main(argv=None) -> int:
    args = create_parser().parse_args(argv)
    from .depth import create_depth_model
    from .pipeline import process_image

    if args.devices > 1:
        raise NotImplementedError(
            "--devices above 1 (a device mesh) is not ported to "
            "nunif_tpu_torch yet (ROADMAP queue 1, multi-device)")
    device = resolve_device(args.device)
    cfg = build_config(args)
    if args.input.lower().endswith((".yml", ".yaml")):
        return import_main(args, cfg, device)
    if args.batch_size:
        args.video_batch = args.batch_size
    depth_model = create_depth_model(args.depth_model, device=device)
    depth_model.load(resolution=args.resolution,
                     checkpoint=args.depth_checkpoint,
                     limit_resolution=args.limit_resolution,
                     generator=torch.Generator(device=device).manual_seed(args.seed))
    if args.depth_aa:
        depth_model.set_depth_aa(_net("iw3.depth_aa", args.depth_aa_checkpoint,
                                      device, args.seed))
    edge_dilation = (DEFAULT_EDGE_DILATION if args.edge_dilation is None
                     else args.edge_dilation)
    if args.export or args.export_disparity:
        return export_main(args, cfg, depth_model, edge_dilation, device)
    side_model = create_stereo_model(args.method, args.stereo_checkpoint,
                                     device=device, seed=args.seed)
    if os.path.splitext(args.input)[1].lower() in VIDEO_EXTS:
        run_video(args, cfg, depth_model, side_model, edge_dilation, device,
                  args.input, args.output)
        print("processed video", file=sys.stderr)
        return 0
    estimator = create_convergence_estimator(args, cfg, device)

    is_dir_out = os.path.isdir(args.input)
    if is_dir_out:
        os.makedirs(args.output, exist_ok=True)
    n_done = 0
    for src in iter_inputs(args.input, args.recursive):
        base = os.path.splitext(os.path.basename(src))[0]
        if os.path.splitext(src)[1].lower() in VIDEO_EXTS:
            vdst = (os.path.join(args.output, base + "." + args.video_format)
                    if is_dir_out or os.path.isdir(args.output) else args.output)
            if run_video(args, cfg, depth_model, side_model, edge_dilation,
                         device, src, vdst):
                n_done += 1
            continue
        if is_dir_out or os.path.isdir(args.output):
            dst = os.path.join(args.output, base + "." + args.format)
        else:
            dst = args.output
        if args.resume and os.path.exists(dst):
            continue
        out = process_image(_load_rgb(src, device), cfg, depth_model, side_model,
                            tta=args.tta, edge_dilation=edge_dilation,
                            debug_depth=args.debug_depth,
                            convergence_estimator=estimator)
        pil_io.save_image(out.float().cpu().numpy(), dst)
        n_done += 1
        logger.info("iw3: %s -> %s", src, dst)
    print(f"processed {n_done} image(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
