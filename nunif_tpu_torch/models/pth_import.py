"""Raw upstream checkpoints (counterpart of ``load_torch_checkpoint`` in
``nunif_tpu/models/pth_import.py``, which the port does not import).

``load_torch_checkpoint(path)`` reads a ``.pth`` / ``.pt`` file with
``torch.load(weights_only=True)`` or a ``.safetensors`` file with the
reader below, and returns ``(name, kwargs, state_dict)``: the nunif
envelope's name and kwargs when the file has one (``{"name", "kwargs",
"state_dict"}``), else ``(None, {}, the file's dict)``.  Values are numpy
arrays: fp32 and fp16 keep their dtype, bf16 widens exactly to fp32.

The ``.safetensors`` reader needs no package: an 8-byte little-endian
header length, a JSON header ``{name: {"dtype", "shape", "data_offsets"}}``
(and an optional ``"__metadata__"``), then the raw little-endian buffer.
F32, F16 and BF16 are read; any other dtype raises ``ValueError``.

``load_torch_model(path)`` (counterpart of the JAX package's) loads a
reference ``.pth`` in its nunif envelope: it converts the state dict by
the importer of the envelope's name (``_IMPORTERS``, aliases in
``_ALIASES``), writes the result beside the file as ``<path>.nztm`` and
reads that cache on later loads while it is not older than the file.
Every row of the JAX package's table is here.  Three of its rows fail
there and work here: ``iw3.sod_v1`` (the JAX row returns the U2NETP tree
without the model's ``u2netp`` scope, so the cache does not fit the
model), ``iw3.dsod_v1`` (an alias the JAX row hands to ``create_model``,
which does not know it; the port builds the canonical model for an alias
that is not registered) and ``sbs.mlbw_l2s`` / ``sbs.mlbw_l4s`` (the JAX
converter takes ``small`` from the envelope's kwargs, which the registered
name implies; the port reads it from the model it built).
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from . import torch_convert as tc

RAW_SUFFIXES = (".pth", ".pt", ".safetensors")


def is_raw_checkpoint(path) -> bool:
    """A raw upstream checkpoint (by suffix), not a ``.nztm``."""
    return str(path).endswith(RAW_SUFFIXES)


def _bf16_to_f32(a: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint32) << 16).view(np.float32)


_SAFETENSORS_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
                       "BF16": np.dtype("<u2")}


def read_safetensors(path) -> dict:
    """{name: ndarray} of a ``.safetensors`` file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(data[8:8 + n])
    buf = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}; the reader takes F32, F16, BF16")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(buf):
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}..{end} "
                             f"do not fit its shape {shape}")
        a = np.frombuffer(buf[begin:end], dtype=dtype).reshape(shape)
        out[name] = _bf16_to_f32(a) if info["dtype"] == "BF16" else a.copy()
    return out


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def load_torch_checkpoint(path):
    """(name, kwargs, {key: ndarray}) of a raw ``.pth`` / ``.pt`` /
    ``.safetensors`` checkpoint."""
    if str(path).endswith(".safetensors"):
        data = read_safetensors(path)
    else:
        data = torch.load(path, weights_only=True, map_location="cpu")
    if isinstance(data, dict) and "state_dict" in data:
        name, kwargs, sd = data.get("name"), data.get("kwargs") or {}, data["state_dict"]
    else:
        name, kwargs, sd = None, {}, data
    return name, kwargs, {k: _numpy(v) for k, v in sd.items()}


def _swin_unet(sd, kwargs, model):
    name = kwargs["__name"]
    scale = {"waifu2x.swin_unet_1x": 1, "waifu2x.swin_unet_2x": 2,
             "waifu2x.swin_unet_4x": 4, "waifu2x.swin_unet_4xl": 4,
             "waifu2x.swin_unet_8x": 8}[name]
    base_dim = kwargs.get("base_dim", 192 if name.endswith("4xl") else 96)
    return tc.convert_swin_unet(sd, base_dim=base_dim, base_layers=2,
                                scale_factor=scale)


_V2_KWARGS = ("base_dim", "lv1_mlp_ratio", "lv2_mlp_ratio", "lv2_ratio")
_VIDEO_INPAINT = (lambda sd, kw, model: tc.convert_light_video_inpaint_v1(sd),
                  ("base_dim", "lv2_mlp_ratio"))


def _cliqa(*heads):
    # reference cliqa checkpoints hold BatchNorm, which the converter folds
    # into the convs: the model is built without a norm
    return (lambda sd, kw, model: tc.convert_cliqa(sd, list(heads)), (),
            {"norm": "none"})


# canonical name -> (converter(state_dict, kwargs, model) -> flax tree of
# ``model``, the envelope kwargs that create_model takes[, create_model
# kwargs that the row fixes])
_IMPORTERS = {
    "waifu2x.upconv_7": (lambda sd, kw, model: tc.convert_upconv7(sd), ()),
    "waifu2x.vgg_7": (lambda sd, kw, model: tc.convert_vgg7(sd), ()),
    "waifu2x.swin_unet_1x": (_swin_unet, ("base_dim", "layer_norm")),
    "waifu2x.swin_unet_2x": (_swin_unet, ("base_dim", "layer_norm")),
    "waifu2x.swin_unet_4x": (_swin_unet,
                             ("base_dim", "layer_norm", "pre_antialias")),
    "waifu2x.swin_unet_4xl": (_swin_unet, ()),
    "waifu2x.swin_unet_8x": (_swin_unet, ()),
    "waifu2x.swin_unet_v2_1x": (
        lambda sd, kw, model: tc.convert_swin_unet_v2(
            sd, first_layers=kw.get("first_layers", 2),
            last_layers=kw.get("last_layers", 3)),
        _V2_KWARGS + ("first_layers", "last_layers")),
    "waifu2x.swin_unet_v2_2x": (lambda sd, kw, model: tc.convert_swin_unet_v2(sd),
                                _V2_KWARGS),
    "waifu2x.swin_unet_v2_4x": (lambda sd, kw, model: tc.convert_swin_unet_v2(sd),
                                _V2_KWARGS),
    "waifu2x.cunet": (lambda sd, kw, model: tc.convert_cunet(sd, scale=1), ()),
    "waifu2x.upcunet": (lambda sd, kw, model: tc.convert_cunet(sd, scale=2), ()),
    "waifu2x.wgmlp_4x": (lambda sd, kw, model: tc.convert_wgmlp(sd),
                         ("base_dim", "lv1_mlp_ratio", "lv2_mlp_ratio")),
    "sbs.row_flow_v2": (lambda sd, kw, model: tc.convert_row_flow_v2(sd), ()),
    "sbs.row_flow_v3": (lambda sd, kw, model: tc.convert_row_flow_v3(sd), ()),
    "sbs.mlbw": (lambda sd, kw, model: tc.convert_mlbw(sd, small=model.small),
                 ("num_layers", "base_dim", "small", "hole_mask")),
    "inpaint.light_inpaint_v1": (
        lambda sd, kw, model: tc.convert_light_inpaint_v1(sd), ()),
    "inpaint.light_video_inpaint_v1": _VIDEO_INPAINT,
    "inpaint.light_video_inpaint_v1_medium": _VIDEO_INPAINT,
    "inpaint.light_video_inpaint_v1_large": _VIDEO_INPAINT,
    "iw3.depth_aa": (lambda sd, kw, model: tc.convert_depth_aa(sd), ()),
    "iw3.sod_v1": (lambda sd, kw, model: {"u2netp": tc.convert_u2netp(sd, "u2netp.")},
                   ()),
    "cliqa.jpeg_quality": _cliqa("quality_output", "subsampling_output"),
    "cliqa.grain_noise_level": _cliqa("noise_level_output"),
    "cliqa.scale_factor": _cliqa("scale_factor_output"),
    "stlizer.light_outpaint_v1": (
        lambda sd, kw, model: tc.convert_light_outpaint_v1(sd), ()),
}

# the reference's aliases -> canonical importer names
_ALIASES = {
    "waifu2x.winc_unet_1x": "waifu2x.swin_unet_v2_1x",
    "waifu2x.winc_unet_2x": "waifu2x.swin_unet_v2_2x",
    "waifu2x.winc_unet_4x": "waifu2x.swin_unet_v2_4x",
    "waifu2x.swin_unet_1x_v2": "waifu2x.swin_unet_v2_1x",
    "inpaint.light_video_inpaint_v1_small": "inpaint.light_video_inpaint_v1",
    "iw3.dsod_v1": "iw3.sod_v1",
    "sbs.mlbw_l2": "sbs.mlbw",
    "sbs.mlbw_l4": "sbs.mlbw",
    "sbs.mlbw_l2s": "sbs.mlbw",
    "sbs.mlbw_l4s": "sbs.mlbw",
    "sbs.mask_mlbw_l2": "sbs.mlbw",
}


def canonical_name(name: str) -> str:
    """The importer row of ``name`` (an alias's target, else ``name``)."""
    return _ALIASES.get(name, name)


def supported_torch_models():
    return sorted(set(_IMPORTERS) | set(_ALIASES))


def convert_torch_state(name: str, kwargs: dict, sd: dict):
    """The model ``name`` (on the CPU) with the converted state dict
    loaded."""
    from .flax_params import from_flax
    from .register import create_model, get_model_names
    canonical = canonical_name(name)
    if canonical not in _IMPORTERS:
        raise ValueError(f"no importer for a {name!r} .pth checkpoint; "
                         f"supported: {supported_torch_models()}")
    converter, keep, *fixed = _IMPORTERS[canonical]
    create_kw = {k: v for k, v in kwargs.items() if k in keep}
    create_kw.update(*fixed)
    # an alias the registry does not know builds its canonical model
    model = create_model(name if name in get_model_names() else canonical,
                         **create_kw)
    tree = converter(sd, dict(kwargs, __name=canonical), model)
    from_flax(model, tc.flatten(tree))
    return model


def load_torch_model(path: str, device="cuda"):
    """(model, meta) of a reference ``.pth`` checkpoint, in eval mode on
    ``device``.  The converted weights go to ``<path>.nztm`` on the first
    load and come from there on later ones (while the cache is not older
    than the file)."""
    from ..core.device import resolve_device
    from .io import load_model as load_nztm, save_model
    cache_path = path + ".nztm"
    if os.path.exists(cache_path) and (
            os.path.getmtime(cache_path) >= os.path.getmtime(path)):
        return load_nztm(cache_path, device=device)
    name, kwargs, sd = load_torch_checkpoint(path)
    if name is None:
        raise ValueError(f"{path}: a raw state dict without a nunif envelope; "
                         "use the converters of models.torch_convert")
    from .io import ensure_registered
    ensure_registered(canonical_name(name))
    device = resolve_device(device)
    model = convert_torch_state(name, kwargs, sd)
    try:
        save_model(model, cache_path)
    except OSError:
        pass  # a read-only directory: convert again next time
    model.eval().requires_grad_(False).to(device)
    return model, {"name": name, "kwargs": kwargs, "imported_from": path}
