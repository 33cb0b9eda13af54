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


def register_model_factory(name: str, factory: Callable[..., nn.Module]):
    """Register a function that builds a model under another name (e.g. a
    registered class with fixed arguments)."""
    _models[name] = factory


def register_model_alias(alias: str, name: str):
    """Register ``alias`` for the registered ``name`` (the reference's
    ``winc_unet_*`` names, for example); raises ``KeyError`` if ``name`` is
    not registered."""
    if name not in _models:
        raise KeyError(name)
    _models[alias] = _models[name]


def create_model(name: str, **kwargs) -> nn.Module:
    if name not in _models:
        raise ValueError(f"unknown model: {name!r} (known: {sorted(_models)})")
    return _models[name](**kwargs)


def get_model_names():
    return sorted(_models.keys())


def resolve_alias(name: str) -> str:
    """The ``model_name`` of the class registered under ``name`` (an alias
    resolves to its target's); ``name`` itself for a factory or an unknown
    name."""
    canonical = getattr(_models.get(name), "model_name", None)
    return canonical or name
