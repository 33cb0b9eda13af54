"""Weight-decay masking (counterpart of ``nunif_tpu/training/wd_groups.py``).

The mask is decided on each parameter's flax path (``models.flax_keys``,
the port's flax <-> torch name map), so the same leaves are excluded from
decay as in the JAX package: 1-D parameters and any path with a no-decay
name (bias, norm scales, position bias tables, embeddings, FrozenBatchNorm
statistics).
"""
from __future__ import annotations

from torch import nn

from ..models.flax_params import flax_keys

NO_DECAY_NAMES = (
    "bias", "scale", "relative_position_bias_table", "embedding", "pos_embed",
    "mean", "var",
)


def decide(flax_path: str, ndim: int) -> bool:
    """True: weight decay applies to the parameter at ``flax_path``."""
    if any(n in NO_DECAY_NAMES for n in flax_path.split("/")):
        return False
    return ndim >= 2


def wd_mask(module: nn.Module) -> dict:
    """{torch parameter name: True where weight decay applies}."""
    keys = flax_keys(module)
    return {name: decide(keys[name], p.dim())
            for name, p in module.named_parameters()}
