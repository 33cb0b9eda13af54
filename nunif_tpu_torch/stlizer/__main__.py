"""stlizer CLI (counterpart of ``nunif_tpu/stlizer/__main__.py``, every
flag with its default).

    python -m nunif_tpu_torch.stlizer -i shaky.mp4 -o stable.mp4
    python -m nunif_tpu_torch.stlizer -i shaky.mp4 -o stable.mp4 \\
        --checkpoint superpoint.nztm --border outpaint

Without ``--checkpoint`` SuperPoint is flax's init drawn from ``--seed``
(meaningless keypoints: smoke use only), and so is the outpaint net.
``--device`` defaults to ``cuda`` and fails where CUDA is missing.
"""
import argparse
import logging
import sys


def create_parser():
    p = argparse.ArgumentParser(prog="stlizer", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--smoothing", type=float, default=2.0,
                   help="smoothing window in seconds")
    p.add_argument("--filter", default="gaussian",
                   choices=["gaussian", "savgol", "grad_opt"])
    p.add_argument("--border", default="black",
                   choices=["black", "crop", "expand", "outpaint"])
    p.add_argument("--padding", type=float, default=0.05)
    p.add_argument("--resolution", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-fps", type=float, default=30.0)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="SuperPoint .nztm checkpoint")
    p.add_argument("--video-codec", default="libx264")
    p.add_argument("--crf", type=int, default=20)
    p.add_argument("--preset", default="ultrafast")
    p.add_argument("--pix-fmt", default="yuv420p")
    p.add_argument("--iteration", type=int, default=50,
                   help="frame transform optimization iterations")
    p.add_argument("--disable-cache", action="store_true",
                   help="disable the pass1-2 analysis cache")
    p.add_argument("--debug", action="store_true",
                   help="output original | stabilized side-by-side")
    p.add_argument("--buffer-decay", type=float, default=0.75,
                   help="accepted for compatibility (the outpaint net runs "
                        "frame by frame)")
    p.add_argument("--video-bitrate", default=None)
    p.add_argument("--tune", nargs="+", default=[])
    p.add_argument("--profile-level", default=None)
    p.add_argument("--video-format", "-vf", default="mp4",
                   choices=["mp4", "mkv", "avi"])
    p.add_argument("--colorspace", default="auto",
                   choices=["auto", "bt709", "unspecified"])
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda fails where CUDA is missing")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without a checkpoint")
    return p


def main(argv=None) -> int:
    args = create_parser().parse_args(argv)
    from ..core.device import resolve_device
    from ..video import VideoOutputConfig
    from .pipeline import MAX_KEYPOINTS, stabilize_video
    device = resolve_device(args.device)
    superpoint = None
    if args.checkpoint:
        # the stabilizer's own SuperPoint (512 keypoints) on the file's weights
        from ..models import from_flax, read_checkpoint
        from ..utils.superpoint import SuperPoint
        _meta, flat = read_checkpoint(args.checkpoint)
        superpoint = from_flax(SuperPoint(max_num_keypoints=MAX_KEYPOINTS), flat)
        superpoint = superpoint.eval().requires_grad_(False).to(device)
    vc = VideoOutputConfig(codec=args.video_codec, crf=args.crf,
                           preset=args.preset, pix_fmt=args.pix_fmt,
                           max_fps=args.max_fps, bitrate=args.video_bitrate,
                           tune=tuple(args.tune), profile_level=args.profile_level)
    info = stabilize_video(
        args.input, args.output, resolution=args.resolution,
        smoothing=args.smoothing, filter_name=args.filter, border=args.border,
        padding=args.padding, batch_size=args.batch_size, max_fps=args.max_fps,
        cache_dir=args.cache_dir, use_cache=not args.disable_cache,
        iteration=args.iteration, debug=args.debug, superpoint=superpoint,
        video_config=vc, device=device, seed=args.seed)
    print(f"stabilized {info['frames']} frames @ {info['fps']:.2f} fps",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
