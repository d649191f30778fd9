"""Anchor generation for the anchor-based heads (RPN, RetinaNet).

Counterpart of ``dsl_tpu/core/anchors.py`` (``AnchorGenerator``,
``anchor_generator_from_cfg``): per-level base anchors from
``octave_base_scale`` / ``scales_per_octave`` (or explicit ``scales``) x
``ratios``, centred at ``center_offset * stride``, tiled over the feature
grid row-major over (y, x, anchor). The anchors are computed in float32
numpy exactly as the JAX package computes them, then kept on each device
they are asked for (one upload per feature-map size and device, so a
predict or a step makes no host-to-device copy for them).
``SSDAnchorGenerator`` (and its V1.x form) is SSD's ladder: per level
``2 + 2 * len(ratios[k])`` anchors (4/6/6/6/4/4 for SSD300), the two
squares first.
"""

from __future__ import annotations

import numpy as np
import torch


class AnchorGenerator:
    def __init__(self, strides, ratios=(0.5, 1.0, 2.0), scales=None,
                 octave_base_scale=None, scales_per_octave=None,
                 base_sizes=None, center_offset=0.0, legacy=False):
        # each stride may be an int or an (sx, sy) pair (mmdet semantics)
        self.strides = [tuple(s) if isinstance(s, (tuple, list))
                        else (int(s), int(s)) for s in strides]
        self.ratios = np.asarray(ratios, np.float32)
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            octave_scales = np.asarray(
                [2 ** (i / scales_per_octave)
                 for i in range(scales_per_octave)], np.float32)
            self.scales = octave_scales * octave_base_scale
        else:
            self.scales = np.asarray([8.0], np.float32)
        self.base_sizes = list(base_sizes) if base_sizes is not None else \
            [min(s) for s in self.strides]
        self.center_offset = center_offset
        self.legacy = legacy        # MMDet V1.x anchors (LegacyAnchorGenerator)
        self._on_device: dict = {}

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)

    def num_base_anchors_level(self, level: int) -> int:
        """Anchors per position on ``level`` (the same on every level here;
        SSD's ladder varies)."""
        return self.num_base_anchors

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def base_anchors(self, level: int) -> np.ndarray:
        """(A, 4) anchors centred at ``offset * stride`` for one level;
        ``legacy=True`` gives the V1.x generator's rounded corners."""
        base = self.base_sizes[level]
        w = base * np.sqrt(1.0 / self.ratios)[:, None] * self.scales[None, :]
        h = base * np.sqrt(self.ratios)[:, None] * self.scales[None, :]
        w = w.reshape(-1)
        h = h.reshape(-1)
        if self.legacy:
            cx = self.center_offset * (base - 1)
            cy = self.center_offset * (base - 1)
            return np.round(np.stack(
                [cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                 cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)], axis=-1))
        cx = self.center_offset * self.strides[level][0]
        cy = self.center_offset * self.strides[level][1]
        return np.stack([cx - 0.5 * w, cy - 0.5 * h,
                         cx + 0.5 * w, cy + 0.5 * h], axis=-1)

    def grid_anchors_level(self, featmap_size, level: int) -> np.ndarray:
        """(H*W*A, 4) anchors for one level (row-major y, x, anchor)."""
        h, w = featmap_size
        sx, sy = self.strides[level]
        base = self.base_anchors(level)                  # (A, 4)
        xs = np.arange(w, dtype=np.float32) * sx
        ys = np.arange(h, dtype=np.float32) * sy
        xx, yy = np.meshgrid(xs, ys)
        shifts = np.stack([xx.ravel(), yy.ravel(),
                           xx.ravel(), yy.ravel()], axis=-1)  # (HW, 4)
        anchors = shifts[:, None, :] + base[None, :, :]       # (HW, A, 4)
        return anchors.reshape(-1, 4).astype(np.float32)

    def grid_anchors(self, featmap_sizes, device: torch.device | str = "cpu"
                     ) -> list[torch.Tensor]:
        """Each level's (H*W*A, 4) f32 anchors on ``device``."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature maps for "
                             f"{self.num_levels} anchor levels")
        key = (tuple(tuple(int(v) for v in s) for s in featmap_sizes),
               str(torch.device(device)))
        if key not in self._on_device:
            self._on_device[key] = [
                torch.from_numpy(self.grid_anchors_level(sz, i)).to(device)
                for i, sz in enumerate(featmap_sizes)]
        return self._on_device[key]

    def flat_anchors(self, featmap_sizes, device: torch.device | str = "cpu"
                     ) -> torch.Tensor:
        """All levels concatenated in level order: (sum H*W*A, 4)."""
        return torch.cat(self.grid_anchors(featmap_sizes, device), dim=0)


# SSD's first level by (input size, basesize_ratio_range[0] in percent):
# its (min, max) size in percent of the input
SSD_FIRST_LEVEL = {(300, 15): (7, 15), (300, 20): (10, 20),
                   (512, 10): (4, 10), (512, 15): (7, 15)}


class SSDAnchorGenerator(AnchorGenerator):
    """SSD's anchor ladder (``dsl_tpu/core/anchors.py::SSDAnchorGenerator``).

    Level k: base size ``min_sizes[k]``, scales ``[1, sqrt(max_sizes[k] /
    min_sizes[k])]``, ratios ``[1] + [1/r, r for r in ratios[k]]``, the
    anchors ordered scale-minor and reindexed so that the two squares come
    first, then the aspect anchors of scale 1. ``min/max_sizes`` default
    from the ``basesize_ratio_range`` percent ladder with the input size's
    own first level. ``legacy=True`` centres at ``(stride - 1) / 2`` with
    the V1.x rounded ``(w - 1)`` corners."""

    def __init__(self, strides, ratios, min_sizes=None, max_sizes=None,
                 basesize_ratio_range=(0.15, 0.9), input_size=300,
                 legacy=False):
        self.strides = [tuple(s) if isinstance(s, (tuple, list))
                        else (int(s), int(s)) for s in strides]
        self.legacy = legacy
        num_levels = len(self.strides)
        if min_sizes is None and max_sizes is None:
            min_ratio = int(basesize_ratio_range[0] * 100)
            max_ratio = int(basesize_ratio_range[1] * 100)
            step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
            min_sizes, max_sizes = [], []
            for ratio in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(int(input_size * ratio / 100))
                max_sizes.append(int(input_size * (ratio + step) / 100))
            first = SSD_FIRST_LEVEL.get((input_size, min_ratio))
            if first is None:
                raise ValueError(
                    f"unsupported (input_size, basesize_ratio_range[0]) = "
                    f"({input_size}, {basesize_ratio_range[0]})")
            min_sizes.insert(0, int(input_size * first[0] / 100))
            max_sizes.insert(0, int(input_size * first[1] / 100))
        if not len(min_sizes) == len(max_sizes) == num_levels:
            raise ValueError(f"{len(min_sizes)} min and {len(max_sizes)} max "
                             f"sizes for {num_levels} levels")
        self.base_sizes = list(min_sizes)
        self.max_sizes = list(max_sizes)
        self.level_ratio_cfg = [list(r) for r in ratios]
        if legacy:
            self.centers = [((sx - 1) / 2.0, (sy - 1) / 2.0)
                            for sx, sy in self.strides]
        else:
            self.centers = [(sx / 2.0, sy / 2.0) for sx, sy in self.strides]
        self._on_device = {}

    def num_base_anchors_level(self, level: int) -> int:
        return 2 + 2 * len(self.level_ratio_cfg[level])

    @property
    def num_base_anchors(self) -> int:
        raise AttributeError("SSD anchors vary per level; use "
                             "num_base_anchors_level")

    def base_anchors(self, level: int) -> np.ndarray:
        base = self.base_sizes[level]
        scales = np.array(
            [1.0, np.sqrt(self.max_sizes[level] / base)], np.float32)
        rlist = [1.0]
        for r in self.level_ratio_cfg[level]:
            rlist += [1.0 / r, r]
        ratios = np.asarray(rlist, np.float32)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base * scales[:, None] * w_ratios[None, :]).reshape(-1)
        hs = (base * scales[:, None] * h_ratios[None, :]).reshape(-1)
        cx, cy = self.centers[level]
        if self.legacy:
            anchors = np.round(np.stack(
                [cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                 cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)], axis=-1))
        else:
            anchors = np.stack([cx - 0.5 * ws, cy - 0.5 * hs,
                                cx + 0.5 * ws, cy + 0.5 * hs], axis=-1)
        nr = len(ratios)
        indices = list(range(nr))
        indices.insert(1, nr)          # the two squares first
        return anchors[np.asarray(indices)]


def anchor_generator_from_cfg(cfg: dict | None, **defaults) -> AnchorGenerator:
    """Build an anchor generator from an mmdet-style ``anchor_generator``
    config dict, falling back to the head's ``defaults``:
    ``AnchorGenerator``, ``LegacyAnchorGenerator`` and the two SSD
    generators; any other type is unknown."""
    cfg = dict(cfg or {})
    t = cfg.pop("type", "AnchorGenerator")
    if t in ("SSDAnchorGenerator", "LegacySSDAnchorGenerator"):
        return SSDAnchorGenerator(
            strides=cfg.get("strides", defaults.get("strides")),
            ratios=cfg["ratios"],
            min_sizes=cfg.get("min_sizes"), max_sizes=cfg.get("max_sizes"),
            basesize_ratio_range=tuple(
                cfg.get("basesize_ratio_range", (0.15, 0.9))),
            input_size=cfg.get("input_size", 300),
            legacy=t == "LegacySSDAnchorGenerator")
    if t not in ("AnchorGenerator", "LegacyAnchorGenerator"):
        raise ValueError(f"unsupported anchor_generator type: {t}")
    kw = dict(
        strides=cfg.get("strides", defaults.get("strides")),
        ratios=cfg.get("ratios", defaults.get("ratios", (0.5, 1.0, 2.0))),
        center_offset=cfg.get("center_offset",
                              defaults.get("center_offset", 0.0)),
        base_sizes=cfg.get("base_sizes", defaults.get("base_sizes")),
        legacy=t == "LegacyAnchorGenerator")
    if "scales" in cfg:
        kw["scales"] = cfg["scales"]
    elif "octave_base_scale" in cfg or "octave_base_scale" in defaults:
        kw["octave_base_scale"] = cfg.get(
            "octave_base_scale", defaults.get("octave_base_scale"))
        kw["scales_per_octave"] = cfg.get(
            "scales_per_octave", defaults.get("scales_per_octave"))
    elif defaults.get("scales") is not None:
        kw["scales"] = defaults["scales"]
    return AnchorGenerator(**kw)
