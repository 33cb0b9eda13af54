"""Addons: app modules that register train / training-data commands
(counterpart of ``nunif_tpu/addon.py``).

All nine of the JAX package's addons are ported, in its order: waifu2x,
iw3's sbs, inpaint, sod, depth_aa and da3mono trainers, stlizer's
outpaint trainer, cliqa and imagenet.  waifu2x and sbs also register a
``create_training_data`` command.
"""
from __future__ import annotations

import importlib

ADDON_MODULES = [
    "nunif_tpu_torch.waifu2x.training.trainer",
    "nunif_tpu_torch.iw3.training.sbs.trainer",
    "nunif_tpu_torch.iw3.training.inpaint.trainer",
    "nunif_tpu_torch.iw3.training.sod",
    "nunif_tpu_torch.iw3.training.depth_aa",
    "nunif_tpu_torch.iw3.training.da3mono",
    "nunif_tpu_torch.stlizer.training",
    "nunif_tpu_torch.cliqa.training",
    "nunif_tpu_torch.imagenet.training",
]


def load_addons(kind: str):
    """kind: "train" or "create_training_data".  Returns [(module,
    register_fn)] of the addons that provide that hook."""
    fn_name = {"train": "register_train",
               "create_training_data": "register_create_training_data"}[kind]
    out = []
    for mod_path in ADDON_MODULES:
        mod = importlib.import_module(mod_path)
        fn = getattr(mod, fn_name, None)
        if fn is not None:
            out.append((mod, fn))
    return out
