"""Pass-through and stacked necks.

Counterpart of ``dsl_tpu/models/necks/channel_mapper.py``'s
``IdentityNeck`` (the C4 / DC5 configs name it where the reference has no
neck: the backbone's levels go on unchanged) and ``SequentialNeck`` (a
list ``neck=[...]``, Libra's ``[FPN, BFP]``: the necks in turn, mmcv's
``Sequential``, so their parameters are ``neck.0.``, ``neck.1.``).
``ChannelMapper`` is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from dsl_tpu_torch.registry import MODELS, NECKS, build_from_cfg


@NECKS.register
class IdentityNeck(nn.Module):
    def init_weights(self, generator: torch.Generator | None = None):
        pass

    def forward(self, feats):
        return tuple(feats)


class SequentialNeck(nn.Sequential):
    def init_weights(self, generator: torch.Generator | None = None):
        for neck in self:
            neck.init_weights(generator)


# necks whose JAX modules take their input widths from the levels they are
# given (flax infers a conv's), where the repo's configs give ``in_channels``
# from C3 with ``start_level=1`` over a backbone that gives C2-C5
WIDTHS_FROM_LEVELS = ("NASFPN", "NASFCOS_FPN")


def build_neck(cfg, backbone: nn.Module | None = None) -> nn.Module:
    """A neck config, or a list of them (a :class:`SequentialNeck`, as the
    JAX package's single- and two-stage builders make one). A neck of
    ``WIDTHS_FROM_LEVELS`` gets the backbone's level widths as its
    ``in_channels`` (its ``start_level`` then picks from them, as the JAX
    module picks from the levels)."""
    if isinstance(cfg, (list, tuple)):
        return SequentialNeck(*(build_from_cfg(dict(c), MODELS) for c in cfg))
    cfg = dict(cfg)
    if cfg.get("type") in WIDTHS_FROM_LEVELS:
        widths = getattr(backbone, "out_channels", None)
        if widths is None:
            raise NotImplementedError(
                f"{cfg['type']} reads the widths of the backbone's levels, "
                f"which {type(backbone).__name__} does not give")
        cfg["in_channels"] = list(widths)
    return build_from_cfg(cfg, MODELS)
