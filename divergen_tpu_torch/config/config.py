"""Config tree with YAML ``_BASE_`` inheritance and dotted-list overrides.

The port's own copy of ``divergen_tpu/config/config.py`` (the reference's
yacs ``CfgNode`` stack). Same user surface — ``get_cfg()``,
``cfg.merge_from_file(yaml)`` with ``_BASE_`` chains, ``cfg.merge_from_list
(["MODEL.X", "3"])``, ``cfg.freeze()`` — implemented standalone (no yacs
dependency) on a plain attribute dict so configs stay picklable and cheap.

PyYAML is imported inside the functions that read or dump YAML, so that
``get_cfg()`` and ``merge_from_list`` work on a machine without it;
``merge_from_list`` then parses its values with ``ast.literal_eval``.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

_BASE_KEY = "_BASE_"


class ConfigNode(dict):
    """Attribute-accessible nested dict with freeze support."""

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError(f"Config is frozen; cannot set {key}")
        super().__setitem__(key, value)

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return self._frozen

    def clone(self) -> "ConfigNode":
        node = ConfigNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return node

    # -- merging --------------------------------------------------------
    def _merge_dict(self, other: Dict[str, Any], allow_new: bool = False) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k]._merge_dict(v, allow_new=allow_new)
            else:
                if k not in self and not allow_new:
                    raise KeyError(f"Unknown config key: {k}")
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, filename: str, allow_new: bool = True) -> None:
        """Load YAML, following ``_BASE_`` chains relative to the file."""
        loaded = _load_yaml_with_base(filename)
        self._merge_dict(loaded, allow_new=allow_new)
        hook = getattr(self, "_post_merge", None)
        if hook is not None:
            hook(self)

    def merge_from_list(self, opts: List[str]) -> None:
        """yacs-style pairwise CLI overrides: ``["A.B.C", "value", ...]``."""
        assert len(opts) % 2 == 0, f"odd override list: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf)
            node[leaf] = _coerce(value, old)

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=True)


def _coerce(value: str, old: Any) -> Any:
    """Parse a CLI string with YAML rules, matching the old value's type."""
    parsed = _parse_scalar(value) if isinstance(value, str) else value
    if old is not None and isinstance(old, bool) and not isinstance(parsed, bool):
        return bool(parsed)
    if old is not None and isinstance(old, float) and isinstance(parsed, int):
        return float(parsed)
    if old is not None and isinstance(old, tuple) and isinstance(parsed, list):
        return tuple(parsed)
    return parsed


def _parse_scalar(value: str) -> Any:
    """A CLI string by YAML's rules; without PyYAML, by Python's literal
    rules plus YAML's spellings of booleans and null."""
    try:
        import yaml
    except ImportError:
        low = value.strip().lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "~", ""):
            return None
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    import yaml

    with open(filename) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop(_BASE_KEY, None)
    if base:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        merged = _load_yaml_with_base(base)
        _deep_update(merged, cfg)
        return merged
    return cfg


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
