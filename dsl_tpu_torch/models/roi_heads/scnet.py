"""SCNet's heads.

Counterpart of ``dsl_tpu/models/roi_heads/scnet.py``, NCHW:

- ``SimplifiedBasicBlock``: two bias-free 3x3 convs, each followed by the
  norm of ``norm_cfg`` (``make_norm(None)`` is FrozenBatchNorm in the JAX
  package, so the blocks have one where mmdet's have none), relu after
  the first, then the input (through a bias-free 1x1 ``shortcut`` where the
  widths differ) added and relu (mmdet's ``conv1``, ``bn1``, ``conv2``,
  ``bn2``);
- ``SCNetBBoxHead``: ``Shared2FCBBoxHead`` with a class-specific regressor
  (``num_classes * 4``; mmdet's SCNet heads are class-agnostic) and the
  defaults of a head with no ``loss_bbox`` and no ``bbox_coder`` (L1 on
  the ``DeltaXYWHBBoxCoder`` deltas); with ``return_shared_feat`` it also
  returns ``shared_fcs.1``'s output;
- ``FeatureRelayHead``: an FC to ``s * s * c`` (mmdet's ``fc``) read as a
  (c, s, s) map, mmdet's order (the JAX package reads (s, s, c), and the
  weight bridge permutes the FC's output rows), then
  ``jax.image.resize``'s bilinear enlargement (``ops/resize.py``);
- ``GlobalContextHead``: on the last FPN level, ``num_convs // 2``
  simplified blocks (``conv_to_res``) or ``num_convs`` 3x3 convs with relu
  (mmdet's ``convs.i``), the spatial mean, and ``fc``, a logit per class;
  returns (logits (B, C), pooled (B, conv_out));
- ``SCNetMaskHead``: ``num_convs // 2`` simplified blocks (``convs.i``),
  the 2x transposed conv with relu and ``conv_logits``;
- ``global_context_loss``: binary cross-entropy of the logits against each
  image's class presence (the valid GT labels), the mean over B x C, times
  ``loss_weight``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_, make_norm
from dsl_tpu_torch.models.roi_heads.htc import _ConvModule
from dsl_tpu_torch.models.roi_heads.mask_head import FCNMaskHead
from dsl_tpu_torch.models.roi_heads.standard_roi_head import Shared2FCBBoxHead
from dsl_tpu_torch.ops.resize import resize_bilinear
from dsl_tpu_torch.registry import HEADS


class SimplifiedBasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int,
                 norm_cfg: dict | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, padding=1,
                               bias=False)
        self.bn1 = make_norm(norm_cfg, channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = make_norm(norm_cfg, channels)
        self.shortcut = (nn.Conv2d(in_channels, channels, 1, bias=False)
                         if in_channels != channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


def _he_convs(module: nn.Module, generator):
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            he_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


@HEADS.register
class SCNetBBoxHead(Shared2FCBBoxHead):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_size: int = 7, fc_channels: int = 1024,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2)):
        super().__init__(num_classes, in_channels, roi_size, fc_channels,
                         target_means, target_stds)

    def forward(self, roi_feats: torch.Tensor,
                return_shared_feat: bool = False):
        """roi_feats (N, C, s, s) -> (cls_logits (N, C+1), deltas (N, 4C)),
        and the shared features (N, fc_channels) with
        ``return_shared_feat``."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        if return_shared_feat:
            return self.fc_cls(x), self.fc_reg(x), x
        return self.fc_cls(x), self.fc_reg(x)


@HEADS.register
class FeatureRelayHead(nn.Module):
    def __init__(self, in_channels: int = 1024, out_conv_channels: int = 256,
                 roi_feat_size: int = 7, scale_factor: int = 2):
        super().__init__()
        self.in_channels = in_channels
        self.out_conv_channels = out_conv_channels
        self.roi_feat_size = roi_feat_size
        self.scale_factor = scale_factor
        self.fc = nn.Linear(in_channels,
                            roi_feat_size * roi_feat_size * out_conv_channels)

    def init_weights(self, generator: torch.Generator | None = None):
        nn.init.xavier_uniform_(self.fc.weight, generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, in_channels) -> (N, c, 2s, 2s)."""
        s, c = self.roi_feat_size, self.out_conv_channels
        y = self.fc(x).reshape(-1, c, s, s)
        out = s * self.scale_factor
        return resize_bilinear(y, (out, out))


@HEADS.register
class GlobalContextHead(nn.Module):
    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 loss_weight: float = 1.0, conv_to_res: bool = True,
                 norm_cfg: dict | None = None):
        super().__init__()
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.loss_weight = loss_weight
        if conv_to_res:
            chans = [in_channels] + [conv_out_channels] * (num_convs // 2)
            self.convs = nn.ModuleList(
                SimplifiedBasicBlock(chans[i], chans[i + 1], norm_cfg)
                for i in range(num_convs // 2))
        else:
            chans = [in_channels] + [conv_out_channels] * num_convs
            self.convs = nn.ModuleList(_ConvModule(chans[i], chans[i + 1], 3)
                                       for i in range(num_convs))
        self.fc = nn.Linear(conv_out_channels, num_classes)

    def init_weights(self, generator: torch.Generator | None = None):
        _he_convs(self.convs, generator)
        nn.init.normal_(self.fc.weight, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, feats):
        """FPN levels -> (logits (B, classes), pooled context (B, C))."""
        x = feats[-1]
        for conv in self.convs:
            x = conv(x)
        # a mean, not AdaptiveAvgPool2d, whose CUDA backward adds with atomics
        pooled = x.mean(dim=(2, 3))
        return self.fc(pooled), pooled


@HEADS.register
class SCNetMaskHead(FCNMaskHead):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 12,
                 roi_size: int = 14, norm_cfg: dict | None = None):
        super().__init__(num_classes, in_channels, conv_out_channels, 0,
                         roi_size)
        chans = [in_channels] + [conv_out_channels] * (num_convs // 2)
        self.convs = nn.ModuleList(
            SimplifiedBasicBlock(chans[i], chans[i + 1], norm_cfg)
            for i in range(num_convs // 2))
        self.upsample = nn.ConvTranspose2d(chans[-1], conv_out_channels, 2,
                                           stride=2)

    def init_weights(self, generator: torch.Generator | None = None):
        _he_convs(self, generator)
        nn.init.normal_(self.conv_logits.weight, 0.0, 0.001,
                        generator=generator)


def global_context_loss(logits: torch.Tensor, gt_labels: torch.Tensor,
                        gt_valid: torch.Tensor, num_classes: int,
                        loss_weight: float = 1.0) -> torch.Tensor:
    """logits (B, C); gt_labels (B, K); gt_valid (B, K) f32."""
    onehot = F.one_hot(gt_labels.to(torch.int64).clamp(0, num_classes - 1),
                       num_classes).to(logits.dtype)
    target = (onehot * gt_valid[..., None].to(logits.dtype)).amax(1)
    bce = -(target * F.logsigmoid(logits)
            + (1 - target) * F.logsigmoid(-logits))
    return loss_weight * bce.mean()
