"""sample_frames: write about N evenly spaced frames of a video as PNGs
(counterpart of ``nunif_tpu/iw3/training/sample_frames.py``), named
``<md5(basename + salt)>_<pts ms>.png``, optionally rotated by 90
degrees; decoding through ``video/backend.VideoReader``, PNG encoding in
a thread pool.

    python -m nunif_tpu_torch.iw3.training.sample_frames -i video.mp4 -o out_dir \\
        [--samples 1000] [--rotate-left | --rotate-right]
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

MD5_SALT = "nunif-iw3-training"


def md5_name(basename: str) -> str:
    return hashlib.md5((basename + MD5_SALT).encode()).hexdigest()


def sample_frames(input_path: str, output_dir: str, samples: float = 1000,
                  rotate: int = 0, workers: int = 8) -> int:
    """Decode input_path and write ~samples PNG frames into output_dir.
    rotate: 0, +1 (left / counterclockwise), -1 (right / clockwise).
    Returns the count written."""
    from ...video.backend import VideoReader

    os.makedirs(output_dir, exist_ok=True)
    base = md5_name(os.path.basename(input_path))
    reader = VideoReader(input_path)
    nb = reader.nb_frames
    if nb and nb > 0:
        interval = max(int(nb // samples), 1)
    else:
        # no frame count in the container: estimate it from duration x fps
        est = (reader.duration or 0) * (reader.fps or 0)
        interval = max(int(est // samples), 1) if est else 1

    written = 0
    counter = 0
    futures = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for frame, pts in reader:
            counter += 1
            if counter % interval != 0:
                continue
            im = Image.fromarray(np.asarray(frame))
            if rotate > 0:
                im = im.transpose(Image.Transpose.ROTATE_90)
            elif rotate < 0:
                im = im.transpose(Image.Transpose.ROTATE_270)
            out = os.path.join(output_dir, f"{base}_{int(pts * 1000)}.png")
            futures.append(pool.submit(im.save, out))
            written += 1
            if len(futures) > 100:
                for f in futures:
                    f.result()
                futures.clear()
        for f in futures:
            f.result()
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="extract sample frames from a video for training data")
    p.add_argument("--input", "-i", required=True, help="input video file")
    p.add_argument("--output", "-o", required=True, help="output dir")
    p.add_argument("--samples", type=float, default=1000,
                   help="rough sample frame count")
    p.add_argument("--rotate-left", action="store_true",
                   help="rotate 90 degrees counterclockwise")
    p.add_argument("--rotate-right", action="store_true",
                   help="rotate 90 degrees clockwise")
    args = p.parse_args(argv)
    rotate = 1 if args.rotate_left else (-1 if args.rotate_right else 0)
    n = sample_frames(args.input, args.output, samples=args.samples,
                      rotate=rotate)
    print(f"wrote {n} frames to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
