"""Model base classes (counterpart of ``nunif_tpu/models/model.py``).

Models are ``nn.Module``s on NHWC tensors.  Constructor arguments are kept
as attributes of the same name, so ``model_kwargs`` reads them back for
self-describing checkpoints, as the JAX package reads dataclass fields.
"""
from __future__ import annotations

import inspect
import math
from typing import Optional

import torch
from torch import nn


class Model(nn.Module):
    """Base class for registered models; subclasses set ``model_name``."""
    model_name = None


def model_kwargs(model: nn.Module) -> dict:
    """Constructor kwargs of ``model`` (for checkpoint metadata)."""
    sig = inspect.signature(type(model).__init__)
    out = {}
    for name, p in sig.parameters.items():
        if name == "self" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        out[name] = getattr(model, name)
    return out


class I2IBaseModel(Model):
    """Image-to-image contract: scale, offset (output pixels cropped per
    border), seam-blend width, default tile/batch, and the (modulo, residue)
    constraints on the input tile size."""
    i2i_scale = 1
    i2i_offset = 0
    i2i_blend_size = 0
    i2i_default_tile_size = 256
    i2i_default_batch_size = 4
    i2i_tile_constraints = ()

    def is_valid_tile_size(self, size: int) -> bool:
        if size <= self.i2i_offset * 2 // max(self.i2i_scale, 1):
            return False
        return all(size % m == r for (m, r) in self.i2i_tile_constraints)

    def find_valid_tile_size(self, tile_size: Optional[int]) -> int:
        """Round the requested tile size up to the nearest valid one."""
        if tile_size is None:
            tile_size = self.i2i_default_tile_size
        t = int(tile_size)
        for _ in range(4096):
            if self.is_valid_tile_size(t):
                return t
            t += 1
        raise ValueError(f"no valid tile size >= {tile_size} for {type(self)}")


# flax's lecun_normal draws a normal truncated at +-2 std and divides the
# std by this factor so that the truncated draw keeps variance 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _truncated_normal(shape, std: float, generator: torch.Generator):
    """N(0, std) truncated to [-2 std, 2 std] by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + u * (1.0 - 2.0 * lo)
    return (std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


@torch.no_grad()
def init_flax_default(module: nn.Module, generator: torch.Generator):
    """Initialise like the JAX package's flax modules, by flax leaf name:
    lecun_normal kernels, zero biases and class tokens, unit LayerNorm
    scales, 1e-5 LayerScale gammas, N(0, 0.02) position embeddings,
    truncated_normal(0.02) relative-position tables, truncated_normal(0.01)
    mask tokens, and gMLP's spatial projection: kernel uniform on [0, 2e-3
    / C), unit bias."""
    from .flax_params import flax_keys
    for name, key in flax_keys(module).items():
        p = module.get_parameter(name)
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("bias", "cls_token"):
            p.zero_()
        elif leaf in ("scale", "proj_spatial_bias"):
            p.fill_(1.0)
        elif leaf == "mask_bias":
            p.copy_(_truncated_normal(p.shape, 0.01, generator))
        elif leaf == "proj_spatial_kernel":
            owner = module.get_submodule(name.rpartition(".")[0])
            p.copy_(torch.rand(p.shape, generator=generator)
                    * (2e-3 / owner.embed_dim))
        elif leaf == "gamma":
            p.fill_(1e-5)
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf == "relative_position_bias_table":
            p.copy_(_truncated_normal(p.shape, 0.02, generator))
        elif leaf == "kernel":
            fan_in = math.prod(p.shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
            p.copy_(_truncated_normal(p.shape, std, generator))
        else:
            raise ValueError(f"no flax initializer known for {name}")
