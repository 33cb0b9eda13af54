"""Flag coverage of the port's waifu2x CLI (counterpart of
``nunif_tpu/waifu2x/cli_compat.py``; reference waifu2x/ui_utils.py:217-344).

Each reference flag (``REFERENCE_WAIFU2X_FLAGS``) is in the port's parser,
renamed (``RENAMED``) or not applicable (``NOT_APPLICABLE``, with the
reason); each flag of the JAX package's parser is in the port's unless
``JAX_FLAGS_NOT_IN_PORT`` gives the reason.  ``tests/test_torch_cli_tools.py``
holds both tables.
"""

REFERENCE_WAIFU2X_FLAGS = [
    "batch-size", "colorspace", "compile", "crf", "depth",
    "disable-amp", "disable-compile", "disable-exif-transpose", "format",
    "gpu", "grain", "grain-speed", "grain-strength", "grayscale",
    "image-lib", "input", "max-fps", "method", "model-dir", "noise-level",
    "output", "pix-fmt", "preset", "profile-level", "recursive", "resume",
    "rotate-left", "rotate-right", "start-time", "end-time", "style",
    "tile-size", "tta", "tune", "vf", "video-bitrate", "video-codec",
    "video-format", "yes",
]

NOT_APPLICABLE = {
    "gpu": "--device names the card (one card; several cards are ROADMAP "
           "queue 1, multi-device)",
    "compile": "no torch.compile: the hand kernels are built at first use",
    "disable-compile": "see compile",
    "disable-amp": "the compute dtype is the bf16 policy (core/dtypes.py), "
                   "not a flag",
    "disable-exif-transpose": "images always load EXIF-rotated "
                              "(utils/pil_io.py)",
    "image-lib": "accepted (pil); wand/ImageMagick replaced by design",
    "colorspace": "flag exists; outputs are tagged bt709 for HD by the "
                  "native writer",
}

RENAMED = {"vf": "video-format"}

# flags of the JAX parser that the port's parser does not have
JAX_FLAGS_NOT_IN_PORT = {
    "devices": "the JAX CLI's data-parallel mesh over N devices; the port "
               "runs on one card (ROADMAP queue 1, multi-device)",
}

# flags of the port's parser that the JAX parser does not have
PORT_ONLY_FLAGS = {
    "device": "torch device of the model (cuda by default; cpu for the "
              "plain twins)",
}
