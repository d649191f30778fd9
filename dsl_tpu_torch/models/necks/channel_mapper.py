"""Pass-through neck for the single-level detectors.

Counterpart of ``dsl_tpu/models/necks/channel_mapper.py::IdentityNeck``:
the C4 / DC5 configs name ``IdentityNeck`` where the reference has no neck,
and the backbone's levels go on unchanged. ``ChannelMapper`` and the
stacked necks of that module are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from dsl_tpu_torch.registry import NECKS


@NECKS.register
class IdentityNeck(nn.Module):
    def init_weights(self, generator: torch.Generator | None = None):
        pass

    def forward(self, feats):
        return tuple(feats)
