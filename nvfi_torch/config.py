"""Config system: attribute-access config tree loading the reference YAML schema.

Covers the reference's YACS-style CfgNode surface (reference
utils/cfgnode.py:36-319): construction from nested dicts, attribute access,
yaml load/dump, merge from file / dotted-key list with type coercion,
freeze/defrost immutability, and the deprecated/renamed-key registry
(utils/cfgnode.py:270-319 — deprecated keys warn and are ignored on merge;
renamed keys raise with the new name).  No shipped config registers any, but
the mechanism exists for schema evolution, same as upstream.

The shipped scene configs under configs/ use the same five-block schema as the
reference (wandb / experiment / dataset / renderer / nvfi / segmentation,
reference config/InDoorObj/bat.yaml), so reference YAMLs run unmodified.

This is the PyTorch port's own copy of ``nvfi_tpu/config.py``: the port never
imports the JAX package, not even its jax-free modules.
"""

from __future__ import annotations

import copy
import io
from typing import Any

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """Nested dict with attribute access, freeze support and yaml round-trip."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        for k, v in init_dict.items():
            if isinstance(v, dict):
                self[k] = CfgNode(v)
            else:
                _assert_valid(v, [k])
                self[k] = v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        _assert_valid(value, [name], allow_cfg=True)
        self[name] = value

    def __setitem__(self, key, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- immutability -------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value: bool):
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self, **kwargs) -> str:
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_file(self, path: str):
        with open(path, "r") as f:
            other = CfgNode(yaml.safe_load(f))
        self._merge(other)

    def merge_from_other_cfg(self, other: "CfgNode"):
        self._merge(other)

    def merge_from_list(self, opts: list):
        """Merge from a flat ["a.b.c", value, ...] list with type coercion."""
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            if self.key_is_deprecated(key):
                continue
            if self.key_is_renamed(key):
                self._raise_key_rename_error(key)
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf, None)
            node[leaf] = _coerce(value, old, key)

    # -- deprecated / renamed key registry (reference utils/cfgnode.py:270-319):
    # deprecated keys are warned about and IGNORED on merge; renamed keys
    # raise a KeyError naming the replacement.  Registries live on the
    # instance's __dict__, never inside the config content.
    def register_deprecated_key(self, key: str):
        self._registry("_deprecated_keys", set).add(key)

    def register_renamed_key(self, old: str, new: str, message: str | None = None):
        self._registry("_renamed_keys", dict)[old] = (new, message)

    def key_is_deprecated(self, key: str) -> bool:
        if key in self.__dict__.get("_deprecated_keys", ()):
            import warnings

            warnings.warn(f"deprecated config key (ignoring): {key}")
            return True
        return False

    def key_is_renamed(self, key: str) -> bool:
        return key in self.__dict__.get("_renamed_keys", ())

    def _raise_key_rename_error(self, key: str):
        new, message = self.__dict__["_renamed_keys"][key]
        note = f" Note: {message}" if message else ""
        raise KeyError(
            f"Key {key} was renamed to {new}; please update your config.{note}"
        )

    def _registry(self, name: str, factory):
        if name not in self.__dict__:
            object.__setattr__(self, name, factory())
        return self.__dict__[name]

    def _merge(self, other: "CfgNode", _root: "CfgNode | None" = None,
               _prefix: str = ""):
        root = self if _root is None else _root  # registries live on the root
        for k, v in other.items():
            full = _prefix + k
            if root.key_is_deprecated(full):
                continue
            if root.key_is_renamed(full):
                root._raise_key_rename_error(full)
            if isinstance(v, CfgNode) and isinstance(self.get(k), CfgNode):
                self[k]._merge(v, _root=root, _prefix=full + ".")
            else:
                self[k] = copy.deepcopy(v)

    def __repr__(self):
        return f"CfgNode({super().__repr__()})"


def _assert_valid(value, path, allow_cfg=False):
    ok = isinstance(value, _VALID_TYPES) or (allow_cfg and isinstance(value, (CfgNode, dict)))
    if not ok:
        raise ValueError(f"invalid config value type {type(value)} at {'.'.join(map(str, path))}")


def _coerce(value, old, key):
    """Coerce a string/raw override to the type of the existing value."""
    if old is None or isinstance(value, type(old)):
        # try literal parse for strings with no prior type
        if isinstance(value, str) and old is None:
            try:
                return yaml.safe_load(io.StringIO(value))
            except Exception:
                return value
        return value
    if isinstance(value, str):
        parsed = yaml.safe_load(io.StringIO(value))
        if isinstance(parsed, type(old)) or old is None:
            return parsed
        if isinstance(old, float) and isinstance(parsed, int):
            return float(parsed)
        if isinstance(old, (list, tuple)) and isinstance(parsed, (list, tuple)):
            return type(old)(parsed)
        raise ValueError(f"cannot coerce override {value!r} for {key} (expected {type(old)})")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return type(old)(value)
    raise ValueError(f"type mismatch for {key}: {type(value)} vs {type(old)}")


def load_config(path: str, overrides: list | None = None) -> CfgNode:
    """Load a YAML experiment config (reference train_nvfi.py:27-29)."""
    with open(path, "r") as f:
        cfg = CfgNode(yaml.safe_load(f))
    if overrides:
        cfg.merge_from_list(overrides)
    return cfg
