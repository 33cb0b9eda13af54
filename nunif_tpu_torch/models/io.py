"""``.nztm`` checkpoints without JAX (counterpart of
``nunif_tpu/models/io.py``).

The format is a zip of ``<flax/path>.npy`` files plus ``__meta__.json``
(``{"nunif_tpu_model": 1, "name", "kwargs", "train_kwargs",
"updated_at"}``); both packages read and write the same files.
``load_model`` rebuilds the architecture from ``meta["name"]`` and
``meta["kwargs"]`` through the registry.
"""
from __future__ import annotations

import datetime
import importlib
import io
import json
import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .flax_params import from_flax, to_flax
from .model import model_kwargs
from .register import create_model, get_model_names

FORMAT_KEY = "nunif_tpu_model"
FORMAT_VERSION = 1
META_ENTRY = "__meta__.json"

_APP_PACKAGES = {"waifu2x": "nunif_tpu_torch.waifu2x",
                 "iw3": "nunif_tpu_torch.iw3", "sbs": "nunif_tpu_torch.iw3",
                 "inpaint": "nunif_tpu_torch.iw3"}


class NotPortedError(NotImplementedError):
    """A checkpoint names an architecture the port does not have yet."""


def save_model(model: nn.Module, model_path: str,
               train_kwargs: Optional[dict] = None, **extra_meta):
    meta = {
        FORMAT_KEY: FORMAT_VERSION,
        "name": model.model_name,
        "kwargs": _jsonable(model_kwargs(model)),
        "train_kwargs": _jsonable(train_kwargs) if train_kwargs else None,
        "updated_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    meta.update(_jsonable(extra_meta))
    flat = to_flax(model)
    directory = os.path.dirname(model_path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp_path = model_path + ".tmp"
    with zipfile.ZipFile(tmp_path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(META_ENTRY, json.dumps(meta))
        for key, arr in flat.items():
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            zf.writestr(key + ".npy", buf.getvalue())
    os.replace(tmp_path, model_path)


def read_checkpoint(model_path: str) -> Tuple[dict, dict]:
    """(meta, {flax path: ndarray}) of a ``.nztm`` file."""
    with zipfile.ZipFile(model_path, "r") as zf:
        meta = json.loads(zf.read(META_ENTRY))
        if meta.get(FORMAT_KEY) != FORMAT_VERSION:
            raise ValueError(f"{model_path}: not a nunif_tpu model checkpoint")
        flat = {}
        for info in zf.infolist():
            if info.filename == META_ENTRY:
                continue
            key = info.filename[:-len(".npy")]
            flat[key] = np.load(io.BytesIO(zf.read(info)), allow_pickle=False)
    return meta, flat


def load_model(model_path: str, device="cuda") -> Tuple[nn.Module, dict]:
    """(model, meta): the architecture named by the file, its weights
    loaded, in eval mode on ``device`` (the card unless the caller names
    another; ``device="cpu"`` for the plain twins on the CPU).  Raises if
    CUDA is asked for and absent."""
    meta, flat = read_checkpoint(model_path)
    name = meta["name"]
    package = _APP_PACKAGES.get(name.split(".", 1)[0])
    if package:
        importlib.import_module(package)
    if name not in get_model_names():
        raise NotPortedError(
            f"{model_path}: architecture {name!r} is not ported to "
            f"nunif_tpu_torch yet (ported: {get_model_names()})")
    device = resolve_device(device)
    model = create_model(name, **(meta.get("kwargs") or {}))
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    model.to(device)
    return model, meta


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
