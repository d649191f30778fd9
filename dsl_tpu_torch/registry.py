"""Minimal name→class registry for ``dict(type='X', ...)`` configs.

The port's own copy of ``dsl_tpu/registry.py`` (the port imports nothing of
the JAX package): one registry for every model part, as mmdet's ``MODELS``.
"""

from __future__ import annotations

from typing import Any, Callable


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: dict[str, Callable] = {}

    def get(self, key: str) -> Callable | None:
        return self._map.get(key)

    def register(self, cls: Callable | None = None, *, name: str | None = None):
        """Use as ``@REG.register`` or ``@REG.register(name="X")``."""
        def _do(c: Callable) -> Callable:
            key = name or c.__name__
            if key in self._map:
                raise KeyError(f"{key} already registered in {self._name}")
            self._map[key] = c
            return c

        if cls is None:
            return _do
        return _do(cls)


def build_from_cfg(cfg: dict, registry: Registry) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg-minus-type)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    obj_cls = registry.get(obj_type)
    if obj_cls is None:
        raise KeyError(f"{obj_type} is not registered in {registry._name}; "
                       f"known: {sorted(registry._map)}")
    return obj_cls(**args)


MODELS = Registry("models")
BACKBONES = NECKS = HEADS = DETECTORS = MODELS
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
