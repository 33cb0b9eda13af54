"""Split a video into shot segments, ``<output>/<stem>_NNNN.mp4``
(counterpart of ``nunif_tpu/cli/segment_video.py``): TransNetV2 from
``--checkpoint`` on the card (``--device cpu`` on the CPU), else the
histogram detector.  Reads and writes through the port's libav binding
(``nunif_tpu_torch/video``).

Usage: python -m nunif_tpu_torch.cli.segment_video -i in.mp4 -o outdir/
"""
import argparse
import os
import sys
from fractions import Fraction


def main(argv=None):
    p = argparse.ArgumentParser(prog="segment_video", description=__doc__)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--min-frames", type=int, default=10)
    p.add_argument("--checkpoint", default=None,
                   help="TransNetV2 .nztm checkpoint")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..utils.shot_boundary import detect_boundaries
    from ..video import VideoReader, VideoWriter

    boundaries = detect_boundaries(args.input, threshold=args.threshold,
                                   min_frames=args.min_frames,
                                   checkpoint=args.checkpoint,
                                   device=args.device)
    os.makedirs(args.output, exist_ok=True)
    reader = VideoReader(args.input)
    seg_idx = 0
    writer = None
    frame_no = 0
    bset = set(boundaries)
    base = os.path.splitext(os.path.basename(args.input))[0]
    fps = Fraction(reader.fps).limit_denominator(1001) if reader.fps else Fraction(30)
    for frame, _pts in reader:
        if writer is None or frame_no in bset:
            if writer is not None:
                writer.close()
                seg_idx += 1
            writer = VideoWriter(
                os.path.join(args.output, f"{base}_{seg_idx:04d}.mp4"),
                reader.width, reader.height,
                fps_num=fps.numerator, fps_den=fps.denominator)
        writer.write(frame)
        frame_no += 1
    if writer is not None:
        writer.close()
    reader.close()
    print(f"wrote {seg_idx + 1} segments", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
