"""Multi-level point grid for anchor-free heads.

Counterpart of ``dsl_tpu/core/points.py``: a point at feature cell (y, x)
of a stride-s level sits at image coordinate ``(x*s + int(s*offset),
y*s + int(s*offset))``, row-major over (y, x).
"""

from __future__ import annotations

import torch


class MlvlPointGenerator:
    def __init__(self, strides: list[int], offset: float = 0.5):
        self.strides = list(strides)
        self.offset = offset

    def single_level_points(self, featmap_size: tuple[int, int], stride: int,
                            device: torch.device | str = "cpu") -> torch.Tensor:
        """(H*W, 2) f32 points (x, y) in image coordinates, row-major over
        (y, x)."""
        h, w = featmap_size
        # integer shift, as mmdet's `+ stride // 2`
        shift = int(stride * self.offset)
        x = torch.arange(w, device=device, dtype=torch.float32) * stride + shift
        y = torch.arange(h, device=device, dtype=torch.float32) * stride + shift
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)

    def grid_points(self, featmap_sizes: list[tuple[int, int]],
                    device: torch.device | str = "cpu") -> list[torch.Tensor]:
        if len(featmap_sizes) != len(self.strides):
            raise ValueError(f"{len(featmap_sizes)} feature maps for "
                             f"{len(self.strides)} strides")
        return [self.single_level_points(sz, s, device)
                for sz, s in zip(featmap_sizes, self.strides)]

    def flat_points(self, featmap_sizes: list[tuple[int, int]],
                    device: torch.device | str = "cpu") -> torch.Tensor:
        """All levels concatenated in level order: (sum H*W, 2)."""
        return torch.cat(self.grid_points(featmap_sizes, device), dim=0)
