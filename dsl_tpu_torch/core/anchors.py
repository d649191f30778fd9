"""Anchor generation for the anchor-based heads (RPN, RetinaNet).

Counterpart of ``dsl_tpu/core/anchors.py`` (``AnchorGenerator``,
``anchor_generator_from_cfg``): per-level base anchors from
``octave_base_scale`` / ``scales_per_octave`` (or explicit ``scales``) x
``ratios``, centred at ``center_offset * stride``, tiled over the feature
grid row-major over (y, x, anchor). The anchors are computed in float32
numpy exactly as the JAX package computes them, then kept on each device
they are asked for (one upload per feature-map size and device, so a
predict or a step makes no host-to-device copy for them).
``SSDAnchorGenerator`` is not ported yet and raises.
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

def anchor_generator_from_cfg(cfg: dict | None, **defaults) -> AnchorGenerator:
    """Build an anchor generator from an mmdet-style ``anchor_generator``
    config dict, falling back to the head's ``defaults``:
    ``AnchorGenerator`` and ``LegacyAnchorGenerator``; the SSD generators
    are not ported yet and raise, any other type is unknown."""
    cfg = dict(cfg or {})
    t = cfg.pop("type", "AnchorGenerator")
    if t in ("SSDAnchorGenerator", "LegacySSDAnchorGenerator"):
        raise NotImplementedError(f"{t} is not ported yet")
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
