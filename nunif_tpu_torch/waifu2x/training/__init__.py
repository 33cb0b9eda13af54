"""waifu2x training: the dataset, its degradations and generators, and the
PSNR-mode trainer app (counterpart of ``nunif_tpu/waifu2x/training``)."""
