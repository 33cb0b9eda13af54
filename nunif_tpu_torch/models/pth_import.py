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
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

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
