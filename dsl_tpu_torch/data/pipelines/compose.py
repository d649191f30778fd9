"""Pipeline composition and the test pipeline's parameters.

Counterpart of ``dsl_tpu/data/pipelines/compose.py``. Every transform is
called as ``t(results, rng, pyrng)``: ``rng`` is the
``np.random.RandomState`` and ``pyrng`` the ``random.Random`` that random
transforms draw from, in the JAX package's call order (which draws from
the global ``np.random`` and Python's global ``random``). A transform type
the port does not have raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from dsl_tpu_torch.registry import PIPELINES, build_from_cfg


class Compose:
    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                if PIPELINES.get(t.get("type")) is None:
                    raise NotImplementedError(
                        f"pipeline transform {t.get('type')!r} is not ported "
                        f"to dsl_tpu_torch yet")
                self.transforms.append(build_from_cfg(dict(t), PIPELINES))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be dict or callable: {t}")

    def __call__(self, results, rng, pyrng=None):
        for t in self.transforms:
            results = t(results, rng, pyrng)
            if results is None:
                return None
        return results

    def __repr__(self):
        return ("Compose(" +
                ", ".join(type(t).__name__ for t in self.transforms) + ")")


def test_pipeline_params(pipeline_cfg) -> dict:
    """(img_scale, img_norm) of a test pipeline config, through the
    MultiScaleFlipAug wrapper."""
    img_scale = (1333, 800)
    img_norm = None
    stages = list(pipeline_cfg or [])
    for t in stages:
        t = dict(t)
        if t.get("type") == "MultiScaleFlipAug":
            if t.get("img_scale"):
                img_scale = tuple(t["img_scale"])
            stages = stages + list(t.get("transforms", []))
        elif t.get("type") == "Resize" and t.get("img_scale"):
            sc = t["img_scale"]
            img_scale = tuple(sc[0] if isinstance(sc[0], (list, tuple))
                              else sc)
    # the wrapper's inner transforms too (the loop above saw only the outer)
    for t in stages:
        t = dict(t)
        if t.get("type") == "Normalize":
            img_norm = dict(mean=tuple(t["mean"]), std=tuple(t["std"]),
                            to_rgb=t.get("to_rgb", True))
    return dict(img_scale=img_scale, img_norm=img_norm)
