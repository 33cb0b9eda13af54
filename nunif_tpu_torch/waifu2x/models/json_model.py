"""The original waifu2x JSON weight files (counterpart of
``nunif_tpu/waifu2x/models/json_model.py``).

A JSON file is a list of layers in network order, ``{"class_name",
"weight", "bias", ...}``; they fill upconv_7's or vgg_7's conv layers in
definition order (flax paths ``Conv_0`` .. then ``ConvTranspose2dTorch_0``).
Conv weights are OIHW and go to HWIO; a ``SpatialFullConvolution``
(deconv) weight (I, O, kh, kw) goes to the forward conv's kernel over the
dilated input, (kh, kw, I, O) flipped in space, the layout of
``modules.conv.ConvTranspose2dTorch``.  The weights are set in flax layout
and loaded by ``models.from_flax``, as both packages read ``.nztm`` files.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np

logger = logging.getLogger("nunif_tpu_torch.waifu2x")


def _layer_order(names):
    """``Conv_i`` by index, then ``ConvTranspose*_i``."""
    def key(name):
        m = re.match(r"(.*?)_(\d+)$", name)
        base, idx = (m.group(1), int(m.group(2))) if m else (name, 0)
        return (0 if base == "Conv" else 1, idx)
    return sorted(names, key=key)


def waifu2x_json_flax(flat: dict, json_file: str) -> dict:
    """``flat`` ({flax path: ndarray}, e.g. ``to_flax(model)``) with the
    JSON file's weights and biases poured in, as a new dict."""
    with open(json_file, "r") as f:
        layers = json.load(f)
    out = dict(flat)
    names = _layer_order({key.split("/", 1)[0] for key in flat})
    for li, name in enumerate(names):
        layer = layers[li]
        kernel = out[f"{name}/kernel"]
        if "weight" in layer:
            w = np.asarray(layer["weight"], np.float32)
            if name.startswith("ConvTranspose"):
                w = w.reshape(w.shape[0], w.shape[1], w.shape[-2], w.shape[-1])
                w = w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                w = w.transpose(2, 3, 1, 0)
            if w.shape != kernel.shape:
                raise ValueError(f"{json_file}: layer {li} weight "
                                 f"{w.shape} does not fit {name} {kernel.shape}")
            out[f"{name}/kernel"] = np.ascontiguousarray(w)
        if "bias" in layer and f"{name}/bias" in out:
            out[f"{name}/bias"] = np.asarray(layer["bias"], np.float32).reshape(-1)
    logger.debug("json_model: %d layers read, %d written", len(layers),
                 len(names))
    return out


def load_json_model(json_file: str, arch=None, device="cuda"):
    """The matching model with the JSON weights, in eval mode on
    ``device``.  ``arch``: ``waifu2x.upconv_7`` or ``waifu2x.vgg_7``; when
    omitted, upconv_7 if the last layer is a ``SpatialFullConvolution``."""
    from ...core.device import resolve_device
    from ...models import create_model, from_flax, to_flax
    from . import upconv_7  # noqa: F401  (registers the architectures)
    if arch is None:
        with open(json_file, "r") as f:
            last = json.load(f)[-1].get("class_name", "")
        arch = ("waifu2x.upconv_7" if "FullConvolution" in last
                else "waifu2x.vgg_7")
    device = resolve_device(device)
    model = create_model(arch)
    from_flax(model, waifu2x_json_flax(to_flax(model), json_file))
    return model.eval().requires_grad_(False).to(device)
