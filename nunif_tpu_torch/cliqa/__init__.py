"""cliqa, image-quality scoring for dataset filtering (counterpart of
``nunif_tpu/cliqa/``): patch-based JPEG-quality, grain-noise-PSNR and
resize-quality predictors and the filter CLI."""
from . import models  # noqa: F401  (registers the three predictors)
from .utils import (
    extract_patches, predict_jpeg_quality, predict_grain_noise_psnr,
    predict_resize_quality,
)
