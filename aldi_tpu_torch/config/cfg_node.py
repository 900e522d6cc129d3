"""Hierarchical, typed configuration tree (a copy of
``aldi_tpu/config/cfg_node.py``, kept here so the port imports nothing of
the JAX package).

A from-scratch, dependency-free re-implementation of the config surface the
reference framework exposes (yacs ``CfgNode`` as consumed at
reference ``tools/train_net.py:54-56`` and every ``_BASE_:`` line in
``configs/*.yaml``): attribute access, YAML loading with ``_BASE_``
inheritance, dotted-path CLI override lists, type checking on merge, and
freezing. No behavior is inherited from yacs; this is a small purpose-built
tree (e.g. ``to_dict`` for comparing or hashing a config).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any

import yaml

_VALID_TYPES = (int, float, bool, str, list, tuple, type(None))

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, freeze semantics, and typed merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set {name}: config is frozen")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set {name}: config is frozen")
        super().__setitem__(name, value)

    # -- freeze -------------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return getattr(self, CfgNode.IMMUTABLE)

    # -- clone / convert ------------------------------------------------------
    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        """YAML string of the whole tree (lists stay lists; tuples become lists)."""

        def clean(v):
            if isinstance(v, CfgNode):
                return {k: clean(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return list(v)
            return v

        return yaml.safe_dump(clean(self), default_flow_style=None, sort_keys=True)

    # -- merging --------------------------------------------------------------
    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True) -> None:
        """Load a YAML file, resolving ``_BASE_`` inheritance (deepest first)."""
        loaded = _load_yaml_with_base(cfg_filename)
        self.merge_from_other(CfgNode(loaded))

    def merge_from_other(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_list(self, opts: list) -> None:
        """Merge from a flat list: [KEY1, VALUE1, KEY2, VALUE2, ...]."""
        assert len(opts) % 2 == 0, f"Override list must have even length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)


def _coerce(value: Any, old: Any, full_key: str) -> Any:
    """Parse a CLI string into the type of the value it replaces."""
    if not isinstance(value, str):
        new = value
    else:
        try:
            new = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            new = value  # plain string
    # cross-type allowances mirroring yacs: list<->tuple, int->float
    if isinstance(new, list) and isinstance(old, tuple):
        new = tuple(new)
    elif isinstance(new, tuple) and isinstance(old, list):
        new = list(new)
    if isinstance(old, float) and isinstance(new, int):
        new = float(new)
    if old is not None and new is not None and not isinstance(new, type(old)):
        raise ValueError(
            f"Type mismatch for {full_key}: {type(new).__name__} vs existing "
            f"{type(old).__name__}"
        )
    return new


def _merge_into(src: CfgNode, dst: CfgNode, path: list) -> None:
    for k, v in src.items():
        full = ".".join(path + [k])
        if isinstance(v, CfgNode):
            if k not in dst:
                dst[k] = CfgNode()
            elif not isinstance(dst[k], CfgNode):
                raise ValueError(f"Cannot merge dict into non-dict at {full}")
            _merge_into(v, dst[k], path + [k])
        else:
            if k in dst and dst[k] is not None and v is not None:
                v = _coerce(v, dst[k], full)
            dst[k] = v


def _load_yaml_with_base(filename: str) -> dict:
    with open(filename, "r") as f:
        # yaml.safe_load rejects python tuples; configs use lists/parenthesized
        # strings. Reference configs contain tuple-looking strings like
        # ("a", "b") which YAML parses as a plain string -> literal_eval below.
        cfg = yaml.unsafe_load(f)
    if cfg is None:
        cfg = {}
    cfg = _eval_tuple_strings(cfg)
    base = cfg.pop(BASE_KEY, None)
    if base is not None:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        if not os.path.exists(base) and os.path.exists(base + ".yaml"):
            base = base + ".yaml"  # tolerate configs that omit the extension
        base_cfg = _load_yaml_with_base(base)
        _dict_merge(cfg, base_cfg)
        return base_cfg
    return cfg


def _eval_tuple_strings(obj):
    """YAML parses ("a", "b") as the string '("a", "b")'; recover the tuple."""
    if isinstance(obj, dict):
        return {k: _eval_tuple_strings(v) for k, v in obj.items()}
    if isinstance(obj, str) and obj.startswith("(") and obj.endswith(")"):
        try:
            val = ast.literal_eval(obj)
            if isinstance(val, tuple):
                return val
        except (ValueError, SyntaxError):
            pass
    return obj


def _dict_merge(src: dict, dst: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _dict_merge(v, dst[k])
        else:
            dst[k] = v
