"""Generic CLI tools (counterpart of ``nunif_tpu/cli/``): i2i, merge_model,
count_parameters, diff_image, show_train_args, list_device, segment_video,
convert_model_alias and export_model; ``python -m
nunif_tpu_torch.cli.<tool>``."""
