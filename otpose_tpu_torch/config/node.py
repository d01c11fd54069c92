"""Minimal yacs-compatible config node with ``_BASE_`` file inheritance.

Mirrors the behavior the reference relies on (ref: utils/setup.py:54-106,
configs/arg_parse.py:5-47) so that unmodified reference YAML files parse
here: attribute access, nested nodes, ``_BASE_`` chains resolved relative to
the including file, ``new_allowed`` subtrees (MODEL.EXTRA), and CLI ``opts``
key-value override lists.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"
_NEW_ALLOWED = "__new_allowed__"


class CfgNode(dict):
    """A dict subclass with attribute access and type-checked merging."""

    def __init__(self, init_dict: Dict[str, Any] | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, _NEW_ALLOWED, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = _cfg_from_value(v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _cfg_from_value(value))

    def is_new_allowed(self) -> bool:
        return object.__getattribute__(self, _NEW_ALLOWED)

    # -- cloning -----------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        node = CfgNode(new_allowed=self.is_new_allowed())
        memo[id(self)] = node
        for k, v in self.items():
            node[k] = copy.deepcopy(v, memo)
        return node

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode" | Dict[str, Any]) -> None:
        _merge_into(self, other, [])

    def merge_from_file(self, filename: str) -> None:
        """Load YAML (resolving any ``_BASE_`` chain) and merge into self."""
        loaded = _load_yaml_with_base(filename)
        _merge_into(self, loaded, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge a flat ``[key1, val1, key2, val2, ...]`` override list."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for k in keys[:-1]:
                if k not in node:
                    raise KeyError(f"Non-existent key: {full_key}")
                node = node[k]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"{full_key}: '{k}' is not a config node")
            leaf = keys[-1]
            if leaf not in node and not node.is_new_allowed():
                raise KeyError(f"Non-existent key: {full_key}")
            old = node.get(leaf)
            node[leaf] = _coerce_value(_parse_opt_value(v), old, full_key)

    # -- dumping -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        def _convert(v: Any) -> Any:
            if isinstance(v, CfgNode):
                return {k: _convert(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [_convert(x) for x in v]
            return v

        return {k: _convert(v) for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"


def _cfg_from_value(v: Any) -> Any:
    if isinstance(v, dict) and not isinstance(v, CfgNode):
        return CfgNode(v)
    return v


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f) or {}
    if _BASE_KEY in cfg:
        base_rel = cfg.pop(_BASE_KEY)
        base_path = base_rel
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(filename), base_rel)
        base = _load_yaml_with_base(base_path)
        _dict_deep_merge(base, cfg)
        return base
    return cfg


def _dict_deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _dict_deep_merge(dst[k], v)
        else:
            dst[k] = v


def _merge_into(dst: CfgNode, src: Dict[str, Any], path: List[str]) -> None:
    for k, v in src.items():
        full = ".".join(path + [str(k)])
        if k not in dst:
            if dst.is_new_allowed():
                dst[k] = _cfg_from_value(v)
                continue
            raise KeyError(f"Non-existent config key: {full}")
        old = dst[k]
        if isinstance(old, CfgNode):
            if not isinstance(v, dict):
                raise ValueError(f"Cannot replace config node '{full}' with a leaf value")
            _merge_into(old, v, path + [str(k)])
        else:
            dst[k] = _coerce_value(v, old, full)


def _coerce_value(v: Any, old: Any, full_key: str) -> Any:
    if old is None or v is None:
        return _cfg_from_value(v)
    # yacs semantics: string literals like "(0,1,2,)" decode to python values
    if isinstance(v, str) and not isinstance(old, str):
        import ast

        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    if isinstance(old, tuple) and isinstance(v, (list, tuple)):
        return tuple(v)
    if isinstance(old, list) and isinstance(v, (list, tuple)):
        return list(v)
    # bool is an int subclass: check it first so `True` doesn't coerce to 1.
    if isinstance(old, bool):
        if isinstance(v, bool):
            return v
        raise ValueError(f"Type mismatch for {full_key}: expected bool, got {type(v).__name__}")
    if isinstance(old, float) and isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if isinstance(old, int) and isinstance(v, int) and not isinstance(v, bool):
        return v
    # int default overridden by float (e.g. SIGMA: 3 -> 2.5) — allow, keep float.
    if isinstance(old, int) and isinstance(v, float):
        return v
    if type(old) is type(v):
        return _cfg_from_value(v)
    raise ValueError(
        f"Type mismatch for {full_key}: expected {type(old).__name__}, got {type(v).__name__} ({v!r})"
    )


def _parse_opt_value(v: Any) -> Any:
    """Parse a CLI string override into a python value (yaml semantics)."""
    if not isinstance(v, str):
        return v
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v
