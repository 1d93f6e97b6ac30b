"""TOML configuration system.

Mirrors the reference's config contract (SURVEY.md §5 "Config / flag system",
rumpy/shared_framework/net_train.py:39-44): TOML files with
`experiment`, `[data]`, `[model]`/`[model.internal_params]`, `[training]`
tables; CLI kwargs override file values; and — crucially — every *unset* key
reads as ``None``, which is why model/handler signatures can omit defaults.

The reference achieves None-defaulting by converting the parsed dict into a
recursive ``defaultdict`` (net_train.py:44); here ``NoneDict`` implements the
same semantics explicitly, plus attribute access for ergonomics.

stdlib ``tomllib`` is read-only, so a minimal TOML emitter is included for
writing config copies into experiment dirs (``config_from_epoch_N.toml``
behavior, net_train.py:85-92).
"""

from __future__ import annotations

import copy
import tomllib
from typing import Any, Dict, Mapping


class NoneDict(dict):
    """Dict whose missing keys read as None (nested dicts are NoneDicts too)."""

    def __missing__(self, key):
        return None

    def __getattr__(self, key):
        if key.startswith("__"):
            raise AttributeError(key)
        return self[key]

    def __deepcopy__(self, memo):
        return NoneDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def as_plain(self) -> dict:
        """Strip back to plain dicts (for serialization)."""
        out = {}
        for k, v in self.items():
            out[k] = v.as_plain() if isinstance(v, NoneDict) else v
        return out


def to_none_dict(d: Mapping[str, Any]) -> NoneDict:
    out = NoneDict()
    for k, v in d.items():
        if isinstance(v, Mapping):
            out[k] = to_none_dict(v)
        elif isinstance(v, list):
            out[k] = [to_none_dict(x) if isinstance(x, Mapping) else x for x in v]
        else:
            out[k] = v
    return out


def load_config(path: str) -> NoneDict:
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    return to_none_dict(raw)


def merge_overrides(cfg: NoneDict, overrides: Mapping[str, Any]) -> NoneDict:
    """CLI kwargs override file values; None overrides are ignored
    (matches net_train.py:41-42 where only supplied CLI options win)."""
    cfg = copy.deepcopy(cfg)
    for k, v in overrides.items():
        if v is None:
            continue
        if isinstance(v, Mapping) and isinstance(cfg.get(k), dict):
            cfg[k] = merge_overrides(cfg[k], v)
        else:
            cfg[k] = to_none_dict(v) if isinstance(v, Mapping) else v
    return cfg


# ----------------------------------------------------------------------------
# Minimal TOML emitter (stdlib tomllib cannot write).
# ----------------------------------------------------------------------------

def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    raise TypeError(f"Cannot TOML-serialize {type(v)}: {v!r}")


def _is_table_array(v: Any) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) > 0
            and all(isinstance(x, Mapping) for x in v))


def _emit_table(d: Mapping[str, Any], prefix: str, lines: list) -> None:
    scalars = {k: v for k, v in d.items()
               if v is not None and not isinstance(v, Mapping)
               and not _is_table_array(v)}
    tables = {k: v for k, v in d.items() if isinstance(v, Mapping)}
    table_arrays = {k: v for k, v in d.items() if _is_table_array(v)}
    if prefix and (scalars or not (tables or table_arrays)):
        lines.append(f"[{prefix}]")
    for k, v in scalars.items():
        lines.append(f"{k} = {_fmt_value(v)}")
    if scalars:
        lines.append("")
    for k, v in tables.items():
        _emit_table(v, f"{prefix}.{k}" if prefix else k, lines)
    for k, entries in table_arrays.items():
        name = f"{prefix}.{k}" if prefix else k
        for entry in entries:
            lines.append(f"[[{name}]]")
            for ek, ev in entry.items():
                if ev is not None:
                    lines.append(f"{ek} = {_fmt_value(ev)}")
            lines.append("")


def dump_toml(cfg: Mapping[str, Any], path: str | None = None) -> str:
    if isinstance(cfg, NoneDict):
        cfg = cfg.as_plain()
    lines: list = []
    _emit_table(cfg, "", lines)
    text = "\n".join(lines).rstrip() + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def config_diff(old: Mapping[str, Any], new: Mapping[str, Any], prefix="") -> Dict[str, Any]:
    """Flat dict of dotted-key differences between two configs.

    Stands in for the reference's DeepDiff arbitration
    (base_interface.py:170-206): callers decide whether new params override
    loaded ones via the `new_params_override_load` flag.
    """
    diffs: Dict[str, Any] = {}
    keys = set(old) | set(new)
    for k in sorted(keys):
        ov, nv = old.get(k), new.get(k)
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(ov, Mapping) or isinstance(nv, Mapping):
            diffs.update(config_diff(ov if isinstance(ov, Mapping) else {},
                                     nv if isinstance(nv, Mapping) else {},
                                     path))
        elif ov != nv:
            diffs[path] = {"old": ov, "new": nv}
    return diffs
