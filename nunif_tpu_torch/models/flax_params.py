"""Weights between the JAX package's flax layout and the port's modules.

A flax path ``a/b/c/kernel`` is the torch parameter ``a.b.c.weight``,
except that a ``LayerNorm``'s or ``GroupNorm``'s weight is flax's
``a/b/scale`` (a
``LayerNormNoBias`` holds its ``LayerNorm`` as ``LayerNorm_0``, flax's
auto-name); ``bias`` and every other leaf name
(``relative_position_bias_table``, ``cls_token``, ``pos_embed``,
``ls1/gamma``, the inpaint net's ``mask_bias``, gMLP's
``proj_spatial_kernel`` / ``proj_spatial_bias``) keep their name and
layout.  Video Depth Anything's trees (``pretrained/...``, ``head/...``,
``head/motion_modules_i/...``) follow the same rules.  Dense kernels ``(in, out)``
become Linear weights ``(out, in)``, conv kernels HWIO become OIHW, flax
``ConvTranspose(transpose_kernel=True)`` kernels ``(kh, kw, O, I)`` become
``ConvTranspose2d`` weights ``(I, O, kh, kw)`` by the same 4-D rule, and
everything else keeps its shape.  ``.nztm`` files keep flax paths, so both
packages read them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flax_key(torch_name: str, layer_norm: bool = False) -> str:
    parts = torch_name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "scale" if layer_norm else "kernel"
    return "/".join(parts)


def flax_keys(module: nn.Module) -> dict:
    """{torch parameter name: flax path} for every parameter of module."""
    norms = {name for name, m in module.named_modules()
             if isinstance(m, (nn.LayerNorm, nn.GroupNorm))}
    return {name: flax_key(name, name.rpartition(".")[0] in norms)
            for name, _p in module.named_parameters()}


def _to_flax_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith("weight"):
        if a.ndim == 2:
            return a.T
        if a.ndim == 4:
            return a.transpose(2, 3, 1, 0)
    return a


def _from_flax_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith("weight"):
        if a.ndim == 2:
            return a.T
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
    return a


def to_flax(module: nn.Module) -> dict:
    """{flax path: float32 ndarray in flax layout} for every parameter."""
    keys = flax_keys(module)
    return {keys[name]: np.ascontiguousarray(_to_flax_layout(
                name, p.detach().float().cpu().numpy()))
            for name, p in module.named_parameters()}


@torch.no_grad()
def from_flax(module: nn.Module, flat: dict):
    """Copy flax-layout arrays ``{path: ndarray}`` into ``module``.

    Every parameter must be present with the right shape and no path may be
    left over; otherwise raises ``KeyError`` or ``ValueError`` naming them.
    """
    params = dict(module.named_parameters())
    keys = {key: name for name, key in flax_keys(module).items()}
    missing = sorted(set(keys) - set(flat))
    unexpected = sorted(set(flat) - set(keys))
    if missing or unexpected:
        raise KeyError(f"flax params do not match {type(module).__name__}: "
                       f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    for key, name in keys.items():
        p = params[name]
        a = _from_flax_layout(name, np.asarray(flat[key]))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(np.shape(flat[key]))} does "
                             f"not fit {name} {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(p.dtype))
    return module
