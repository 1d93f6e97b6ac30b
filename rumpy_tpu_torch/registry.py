"""Decorator-based registry of model handlers.

Mirrors ``rumpy_tpu/registry.py``: importing a family module registers its
handlers, and the family modules are imported on the first lookup so that
``import rumpy_tpu_torch`` stays cheap. The degradation-tool registry comes
with the degradation path.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_MODEL_REGISTRY: Dict[str, Any] = {}

# Modules that contain @register_model declarations.
_MODEL_MODULES = [
    "rumpy_tpu_torch.models.advanced",
]

_loaded = {"models": False}


def register_model(name: str) -> Callable[[Any], Any]:
    """Class decorator: register a model handler under ``name`` (lowercase)."""

    def deco(cls):
        _MODEL_REGISTRY[name.lower()] = cls
        cls.registered_name = name.lower()
        return cls

    return deco


def _ensure() -> None:
    if _loaded["models"]:
        return
    _loaded["models"] = True
    for mod in _MODEL_MODULES:
        importlib.import_module(mod)


def available_models() -> Dict[str, Any]:
    _ensure()
    return dict(_MODEL_REGISTRY)


def get_model(name: str):
    _ensure()
    key = name.lower()
    if key not in _MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[key]
