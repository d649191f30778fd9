"""BFP, Libra R-CNN's balanced feature pyramid, NCHW.

Counterpart of ``dsl_tpu/models/necks/bfp.py``: every level is brought to
the ``refine_level``'s size (a max pool at window and stride ``2**d``,
floor mode, below it; ``jax.image.resize``'s nearest above it,
``ops/resize.py::resize_nearest``, whose backward repeats on the card),
the levels are averaged, refined by a 3x3 conv where ``refine_type`` is
``'conv'`` and resized back (nearest) onto each level as a residual.
``refine_type='non_local'`` (the Libra Faster R-CNN configs') runs no
refine, as in the JAX package (mmdet runs a NonLocal2d there), and
``None`` none either.

The refine conv is mmdet's ``refine.conv``; an mmdet checkpoint's
non-local refine (``refine.g``, ``refine.theta``, ...) raises on load,
naming the key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.models.necks.fpn import _ConvModule
from dsl_tpu_torch.ops.resize import resize_nearest
from dsl_tpu_torch.registry import NECKS


@NECKS.register
class BFP(nn.Module):
    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 2, refine_type: str | None = "conv"):
        super().__init__()
        if refine_type not in (None, "conv", "non_local"):
            raise ValueError(f"BFP refine_type {refine_type!r}")
        self.num_levels, self.refine_level = num_levels, refine_level
        self.refine = (_ConvModule(nn.Conv2d(in_channels, in_channels, 3,
                                             padding=1))
                       if refine_type == "conv" else None)

    def init_weights(self, generator: torch.Generator | None = None):
        if self.refine is not None:
            he_normal_(self.refine.conv.weight, generator)
            nn.init.zeros_(self.refine.conv.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.refine is None:
            for key in state_dict:
                if key.startswith(f"{prefix}refine."):
                    raise KeyError(f"{key}: this BFP runs no refine (the JAX "
                                   f"package's, at refine_type "
                                   f"'non_local' or None)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, feats):
        if len(feats) != self.num_levels:
            raise ValueError(f"BFP got {len(feats)} levels for num_levels "
                             f"{self.num_levels}")
        target = feats[self.refine_level].shape[2:]
        gathered = []
        for i, f in enumerate(feats):
            if i < self.refine_level:
                k = 2 ** (self.refine_level - i)
                f = F.max_pool2d(f, k, stride=k)
            elif i > self.refine_level:
                f = resize_nearest(f, target)
            gathered.append(f)
        bsf = sum(gathered) / self.num_levels
        if self.refine is not None:
            bsf = self.refine(bsf)
        return tuple(f + resize_nearest(bsf, f.shape[2:]) for f in feats)
