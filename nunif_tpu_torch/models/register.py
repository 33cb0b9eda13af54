"""Model registry (counterpart of ``nunif_tpu/models/register.py``).

Name -> model class, so a checkpoint rebuilds its own architecture.
"""
from __future__ import annotations

from typing import Callable, Dict

from torch import nn

_models: Dict[str, Callable[..., nn.Module]] = {}


def register_model(cls):
    """Class decorator: register under ``cls.model_name``."""
    name = getattr(cls, "model_name", None)
    if not name:
        raise ValueError(f"{cls} has no `model_name` class attribute")
    _models[name] = cls
    return cls


def create_model(name: str, **kwargs) -> nn.Module:
    if name not in _models:
        raise ValueError(f"unknown model: {name!r} (known: {sorted(_models)})")
    return _models[name](**kwargs)


def get_model_names():
    return sorted(_models.keys())
