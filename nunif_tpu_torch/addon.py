"""Addons: app modules that register train / training-data commands
(counterpart of ``nunif_tpu/addon.py``).

waifu2x's trainer and iw3's inpaint trainer are ported.  The JAX
package's other addons (iw3's sbs, sod, depth_aa and da3mono trainers,
stlizer, cliqa and imagenet) wait for ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import importlib

ADDON_MODULES = [
    "nunif_tpu_torch.waifu2x.training.trainer",
    "nunif_tpu_torch.iw3.training.inpaint.trainer",
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
