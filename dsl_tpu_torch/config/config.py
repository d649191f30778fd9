"""Python-dict configs with ``_base_`` inheritance.

The port's own copy of the part of ``dsl_tpu/config/config.py`` that
``Config.fromfile`` needs: configs are executable Python files whose
module-level names become the config dict; a ``_base_`` entry (str or list)
pulls in parent configs, deep-merged with the child winning; a dict value
holding ``_delete_: True`` replaces the base value instead of merging.
"""

from __future__ import annotations

import copy
import os.path as osp
import sys
import types
from typing import Any

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


class ConfigDict(dict):
    """A dict with attribute access; a missing attribute raises AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'") from e

    @staticmethod
    def wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            wrapped = [ConfigDict.wrap(v) for v in value]
            return tuple(wrapped) if isinstance(value, tuple) else wrapped
        return value


def _load_py_file(filename: str) -> dict:
    """Execute a Python config file and return its module-level names."""
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    with open(filename, encoding="utf-8") as f:
        content = f.read()
    mod = types.ModuleType("_dsl_tpu_torch_cfg")
    mod.__file__ = filename
    old_path = list(sys.path)
    sys.path.insert(0, osp.dirname(filename))
    try:
        exec(compile(content, filename, "exec"), mod.__dict__)
    finally:
        sys.path[:] = old_path
    return {k: v for k, v in mod.__dict__.items()
            if not k.startswith("__")
            and not isinstance(v, (types.ModuleType, types.FunctionType))}


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Deep-merge dict ``a`` (child) into ``b`` (base); the child wins."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and isinstance(b[k], dict):
            if v.pop(DELETE_KEY, False):
                b[k] = copy.deepcopy(v)
            else:
                b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            b[k] = copy.deepcopy(v)
    return b


def _file2dict(filename: str) -> dict:
    cfg_dict = _load_py_file(filename)
    base = cfg_dict.pop(BASE_KEY, None)
    if base is None:
        return cfg_dict
    if isinstance(base, str):
        base = [base]
    cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
    merged: dict = {}
    for b in base:
        parent = _file2dict(osp.join(cfg_dir, b))
        dup = set(merged) & set(parent)
        if dup:
            raise KeyError(f"duplicate keys {dup} in multiple _base_ files")
        merged.update(parent)
    return _merge_a_into_b(cfg_dict, merged)


class Config:
    """A resolved config with dot access."""

    def __init__(self, cfg_dict: dict | None = None):
        self._cfg_dict = ConfigDict.wrap(cfg_dict or {})

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_file2dict(filename))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)
