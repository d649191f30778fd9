"""NAS-FCOS head: FCOS with the searched towers.

Counterpart of ``dsl_tpu/models/dense_heads/nasfcos_head.py``: each of the
classification and regression towers is the searched sequence of a
modulated deformable 3x3 (DCNv2, ``ops/deform_conv.py``, one offset group:
27 offset and mask channels, as the JAX package builds it; no bias), a
3x3, another deformable 3x3 and a 1x1 (with biases), each followed by a
GroupNorm(32) at flax's epsilon 1e-6 (the JAX package's ``nn.GroupNorm``
default; FCOS's towers set 1e-5) and a relu. The predictors, scales, loss
and decode are FCOS's (``fcos_head.py``).

Submodule names are mmdet's: ``cls_convs.{i}.conv`` (the deformable ones
with mmcv's ``conv_offset``) and ``.gn``. mmdet's deformable ops carry a
bias and its plain ones none, the JAX package's the other way round, so an
mmdet checkpoint does not load (its keys have no counterpart here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.dense_heads.fcos_head import FCOSHead
from dsl_tpu_torch.models.layers import refuse_foreign_keys
from dsl_tpu_torch.ops.deform_conv import DeformConv2dPack
from dsl_tpu_torch.registry import HEADS

# the searched ops: (deformable, kernel size)
ARCH = ((True, 3), (False, 3), (True, 3), (False, 1))


class _Op(nn.Module):
    def __init__(self, cin: int, cout: int, deform: bool, k: int):
        super().__init__()
        self.conv = (DeformConv2dPack(cin, cout, 3, bias=False) if deform
                     else nn.Conv2d(cin, cout, k, padding=k // 2))
        self.gn = nn.GroupNorm(32, cout, eps=1e-6)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


@HEADS.register
class NASFCOSHead(FCOSHead):
    def __init__(self, **kwargs):
        if kwargs.get("dcn_on_last_conv"):
            raise ValueError("NASFCOSHead: the searched towers fix their "
                             "deformable convs (no dcn_on_last_conv)")
        super().__init__(**kwargs)
        cin = kwargs.get("in_channels", 256)
        feat = kwargs.get("feat_channels", 256)

        def tower():
            return nn.ModuleList(_Op(cin if i == 0 else feat, feat, d, k)
                                 for i, (d, k) in enumerate(ARCH))

        self.cls_convs = tower()
        self.reg_convs = tower()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        refuse_foreign_keys(self, state_dict, prefix,
                            "the JAX package's NASFCOSHead (mmdet's differs)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
