"""Decorator-based registries of model handlers and degradation ops.

Mirrors ``rumpy_tpu/registry.py``: importing a family module registers its
handlers (or ops), and the modules are imported on the first lookup so
that ``import rumpy_tpu_torch`` stays cheap.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_MODEL_REGISTRY: Dict[str, Any] = {}
_TOOL_REGISTRY: Dict[str, Any] = {}

# Modules that contain @register_model / @register_tool declarations.
_MODEL_MODULES = [
    "rumpy_tpu_torch.models.advanced",
    "rumpy_tpu_torch.models.attention_manipulators",
    "rumpy_tpu_torch.models.basic",
    "rumpy_tpu_torch.models.blind_sr",
    "rumpy_tpu_torch.models.contrastive",
    "rumpy_tpu_torch.models.dan",
    "rumpy_tpu_torch.models.dasr",
    "rumpy_tpu_torch.models.dic",
    "rumpy_tpu_torch.models.face_attribute_gans",
    "rumpy_tpu_torch.models.face_models",
    "rumpy_tpu_torch.models.fssr",
    "rumpy_tpu_torch.models.gan_models",
    "rumpy_tpu_torch.models.han_elan",
    "rumpy_tpu_torch.models.ikc",
    "rumpy_tpu_torch.models.metabed",
    "rumpy_tpu_torch.models.regressors",
    "rumpy_tpu_torch.models.san",
    "rumpy_tpu_torch.models.sftmd_variants",
    "rumpy_tpu_torch.models.swinir",
    "rumpy_tpu_torch.models.wavelet",
]
_TOOL_MODULES = [
    "rumpy_tpu_torch.degradations.blur",
    "rumpy_tpu_torch.degradations.noise",
    "rumpy_tpu_torch.degradations.compression",
    "rumpy_tpu_torch.degradations.resize_ops",
]

_loaded = {"models": False, "tools": False}


def register_model(name: str) -> Callable[[Any], Any]:
    """Class decorator: register a model handler under ``name`` (lowercase)."""

    def deco(cls):
        _MODEL_REGISTRY[name.lower()] = cls
        cls.registered_name = name.lower()
        return cls

    return deco


def register_tool(name: str) -> Callable[[Any], Any]:
    """Class decorator: register a degradation-pipeline op under ``name``."""

    def deco(cls):
        _TOOL_REGISTRY[name.lower()] = cls
        cls.registered_name = name.lower()
        return cls

    return deco


def _ensure(kind: str) -> None:
    if _loaded[kind]:
        return
    _loaded[kind] = True
    for mod in _MODEL_MODULES if kind == "models" else _TOOL_MODULES:
        importlib.import_module(mod)


def available_models() -> Dict[str, Any]:
    _ensure("models")
    return dict(_MODEL_REGISTRY)


def available_tools() -> Dict[str, Any]:
    _ensure("tools")
    return dict(_TOOL_REGISTRY)


def get_model(name: str):
    _ensure("models")
    key = name.lower()
    if key not in _MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[key]


def get_tool(name: str):
    _ensure("tools")
    key = name.lower()
    if key not in _TOOL_REGISTRY:
        raise KeyError(
            f"Unknown degradation op '{name}'. Available: {sorted(_TOOL_REGISTRY)}")
    return _TOOL_REGISTRY[key]
