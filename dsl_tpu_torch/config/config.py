"""Python-dict configs with ``_base_`` inheritance.

The port's own copy of the part of ``dsl_tpu/config/config.py`` that
``Config.fromfile`` and the CLIs need: configs are executable Python files
whose module-level names become the config dict; a ``_base_`` entry (str
or list) pulls in parent configs, deep-merged with the child winning; a
dict value holding ``_delete_: True`` replaces the base value instead of
merging. ``merge_from_dict`` applies ``--cfg-options a.b.c=value``
overrides (parsed by :class:`DictAction`), ``dump`` writes the config back
as Python.
"""

from __future__ import annotations

import ast
import copy
import os
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

    def to_dict(self) -> dict:
        return _unwrap(self._cfg_dict)

    def merge_from_dict(self, options: dict) -> None:
        """Merge ``{"a.b.c": value}`` overrides into the config, as mmcv's
        ``Config.merge_from_dict`` (``--cfg-options``) does."""
        nested: dict = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split(".")
            for k in parts[:-1]:
                d = d.setdefault(k, {})
            d[parts[-1]] = v
        self._cfg_dict = ConfigDict.wrap(_merge_a_into_b(nested,
                                                         self.to_dict()))

    def dump(self, file: str | None = None) -> str | None:
        """The config as Python (``name = value`` lines), written to
        ``file`` when one is given, else returned."""
        text = _format_dict(self.to_dict())
        if file is None:
            return text
        os.makedirs(osp.dirname(osp.abspath(file)), exist_ok=True)
        with open(file, "w", encoding="utf-8") as f:
            f.write(text)
        return None


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        out = [_unwrap(v) for v in value]
        return tuple(out) if isinstance(value, tuple) else out
    return value


def _format_dict(d: dict, indent: int = 0) -> str:
    pad = " " * indent
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{k} = dict(")
            lines.append(_format_inner(v, indent + 4))
            lines.append(f"{pad})")
        else:
            lines.append(f"{pad}{k} = {v!r}")
    return "\n".join(lines) + "\n"


def _format_inner(d: dict, indent: int) -> str:
    pad = " " * indent
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{k}=dict(")
            lines.append(_format_inner(v, indent + 4))
            lines.append(f"{pad}),")
        else:
            lines.append(f"{pad}{k}={v!r},")
    return "\n".join(lines)


def parse_cfg_option(value: str) -> Any:
    """A ``--cfg-options`` value as a Python object: a literal where it
    parses as one, true/false and none/null in any case, else the string."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        if value.lower() in ("true", "false"):
            return value.lower() == "true"
        if value.lower() in ("none", "null"):
            return None
        return value


class DictAction:
    """argparse action: ``KEY=VALUE`` pairs into a dict (mmcv's
    ``DictAction``), each value through :func:`parse_cfg_option`."""

    def __init__(self, option_strings, dest, **kwargs):
        self.option_strings = option_strings
        self.dest = dest
        self.nargs = "+"
        self.const = None
        self.default = kwargs.get("default")
        self.type = None
        self.choices = None
        self.required = kwargs.get("required", False)
        self.help = kwargs.get("help")
        self.metavar = kwargs.get("metavar")

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, val = kv.partition("=")
            options[key] = parse_cfg_option(val)
        setattr(namespace, self.dest, options)

    def format_usage(self):
        return "|".join(self.option_strings)
