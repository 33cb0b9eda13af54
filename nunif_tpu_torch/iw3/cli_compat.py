"""Flag coverage of the port's iw3 CLI (counterpart of
``nunif_tpu/iw3/cli_compat.py``).

Two tables, each held by ``tests/test_torch_iw3_cli_extras.py``:
- the JAX package's parser (``nunif_tpu/iw3/cli.py:create_parser``): every
  flag of it is in the port's parser with the same default, unless
  ``JAX_FLAGS_NOT_IN_PORT`` gives the reason;
- the reference iw3 parser (``REFERENCE_IW3_FLAGS``, 88 flags): each is in
  the port's parser, renamed (``RENAMED``) or not applicable
  (``NOT_APPLICABLE``, with the reason).
"""

# none: the port parses every flag of the JAX parser, with its default
JAX_FLAGS_NOT_IN_PORT = {}

# flags of the port's parser that the JAX parser does not have
PORT_ONLY_FLAGS = {
    "device": "torch device of every net (cuda by default; cpu for the "
              "plain twins)",
    "seed": "seed of the random weights drawn without a checkpoint (the "
            "JAX CLI draws PRNGKey(0))",
}

# the reference's add_argument names
REFERENCE_IW3_FLAGS = [
    "anaglyph", "autocrop", "autocrop-mode", "backward", "batch-size",
    "bg-model", "colorspace", "compile", "convergence", "convergence-mode",
    "crf", "cross-eyed", "cuda-stream", "debug-depth", "depth-aa",
    "depth-model", "disable-amp", "disable-exif-transpose",
    "disable-scene-cache", "divergence", "edge-dilation", "ema-decay",
    "ema-normalize", "end-time", "export", "export-depth-fit",
    "export-depth-only", "export-disparity", "find-param",
    "foreground-scale", "format", "full-sbs", "gpu", "half-rgbd",
    "half-sbs", "half-tb", "inpaint-max-width", "inpaint-model", "input",
    "ipd-offset", "keep-aspect-ratio", "keyframe", "keyframe-interval",
    "limit-resolution", "low-vram", "mapper", "mapper-type",
    "mask-inner-dilation", "mask-outer-dilation", "max-fps",
    "max-output-height", "max-output-width", "max-workers", "metadata",
    "method", "output", "pad", "pad-mode", "pix-fmt", "preset",
    "preserve-screen-border", "profile-level", "recursive", "remove-bg",
    "resolution", "resume", "rgbd", "rotate-left", "rotate-right",
    "scene-cache-dir", "scene-cache-file", "scene-detect",
    "scene-detect-only", "start-time", "stereo-width", "synthetic-view",
    "tb", "tta", "tune", "update", "vf", "video-bitrate", "video-codec",
    "video-format", "vr180", "warp-steps", "yes", "zoed-batch-size",
    "zoed-height",
]

NOT_APPLICABLE = {
    "gpu": "--device names the card (one card; --devices above 1 is ROADMAP "
           "queue 1, multi-device)",
    "cuda-stream": "one CUDA stream; overlap is the video path's (ROADMAP "
                   "queue 2, the video paths' host stages)",
    "low-vram": "the batch size sets the memory (a batch of 1 is the "
                "low-memory path)",
    "disable-amp": "the compute dtype is the bf16 policy (core/dtypes.py), "
                   "not a flag",
    "compile": "no torch.compile: the hand kernels are built at first use",
    "bg-model": "rembg background removal needs the rembg package",
    "remove-bg": "see bg-model",
    "update": "re-downloads torch.hub models; weights load from local "
              ".nztm / .pth files",
    "find-param": "the reference's interactive parameter sweep",
    "export-depth-fit": "the export is always full-resolution 16-bit",
    "inpaint-model": "the inpaint net is part of --method",
    "mapper-type": "--mapper takes every mapper name",
    "scene-cache-file": "--scene-cache-dir covers it",
    "disable-exif-transpose": "images always load EXIF-rotated (utils/pil_io.py)",
    "keyframe": "--keyframe-interval covers it",
    "full-sbs": "full SBS is the default output",
    "backward": "--method backward covers it",
}

# reference names that map to a differently named flag here
RENAMED = {
    "zoed-batch-size": "batch-size",
    "zoed-height": "resolution",
    "vf": "video-format",
}
