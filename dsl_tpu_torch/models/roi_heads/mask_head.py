"""The FCN mask head, its targets from per-GT crops, its loss, and the paste
of predicted masks.

Counterpart of ``dsl_tpu/models/roi_heads/mask_head.py``:

- ``FCNMaskHead``: ``num_convs`` 3x3 convs with relu, a 2x2 stride-2
  transposed conv with relu, and a 1x1 conv of a logit per class; NCHW
  (RoI features (N, C, s, s) -> logits (N, classes, 2s, 2s)), under
  mmdet's names ``convs.i.conv``, ``upsample`` and ``conv_logits``. The
  JAX head is NHWC and its flax ``ConvTranspose`` (padding 'SAME', kernel
  not transposed) computes ``out[2i + a] = x[i] k[1 - a]``: the weight
  bridge flips the 2x2 kernel and swaps its channels
  (``utils/jax_bridge.py``). With ``predictor_cfg=dict(type=
  'NormedConv2d')`` (the Seesaw configs') ``conv_logits`` is the JAX
  package's ``NormedConv`` (``layers.NormedConv2d``, no bias);
- ``gt_mask_crop``: one GT mask cropped to its box (floor and ceil,
  at least a pixel) and resized to (M, M) by OpenCV's float
  ``INTER_LINEAR`` (``image_ops.resize_linear_f32``, on the mask's device);
- ``mask_targets_from_crops``: the target of each RoI resampled from its
  GT's crop: a 1-pixel zero ring, the RoI in the crop's pixels (clipped at
  +-4M), aligned RoIAlign with ``sampling_ratio=2`` (``ops/roi_align.py``)
  and a threshold at 0.5. The port's RoIAlign sums its taps in another
  order than JAX's, so a value within a few ulps of 0.5 may fall on the
  other side;
- ``mask_head_loss``: the assigned class's logits, binary cross-entropy
  per pixel averaged per RoI, then over the positives;
- ``select_positive_rois``: a stable sort with the positives first, as
  ``jnp.argsort(~p)``;
- ``paste_masks``: each RoI's probabilities resized to its box in the
  original image (``resize_linear_f32``, OpenCV's float ``INTER_LINEAR``)
  and thresholded, on the probabilities' device. Past an 8x upscale the
  resize is within 32 ulps of OpenCV's, not equal (``image_ops``), so a
  pasted pixel may differ from the JAX package's where OpenCV's value lies
  within 32 ulps of the threshold.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_f32
from dsl_tpu_torch.models.layers import NormedConv2d, he_normal_
from dsl_tpu_torch.ops.roi_align import roi_align
from dsl_tpu_torch.registry import HEADS

GT_MASK_CROP_SIZE = 112   # each GT's mask crop in the batch


class _MaskConv(nn.Module):
    """mmcv ``ConvModule`` of a 3x3 conv and relu (``convs.i.conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


@HEADS.register
class FCNMaskHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 4,
                 roi_size: int = 14, predictor_cfg: dict | None = None):
        super().__init__()
        pred = dict(predictor_cfg or {})
        if pred and pred.get("type") not in ("Conv", "NormedConv2d"):
            raise ValueError(f"unsupported mask predictor_cfg: {pred}")
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.roi_size = roi_size
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList(_MaskConv(chans[i], chans[i + 1])
                                   for i in range(num_convs))
        self.upsample = nn.ConvTranspose2d(chans[-1], conv_out_channels, 2,
                                           stride=2)
        self.conv_logits = (
            NormedConv2d(conv_out_channels, num_classes, 1,
                         float(pred.get("tempearture", 20)))
            if pred.get("type") == "NormedConv2d"
            else nn.Conv2d(conv_out_channels, num_classes, 1))

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs and upsample, normal 0.001 logits (the JAX
        head's ``conv_logits``; a normed predictor's he-normal), zero
        biases."""
        for conv in [c.conv for c in self.convs] + [self.upsample]:
            he_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
        if isinstance(self.conv_logits, NormedConv2d):
            he_normal_(self.conv_logits.weight, generator)
            return
        nn.init.normal_(self.conv_logits.weight, 0.0, 0.001,
                        generator=generator)
        nn.init.zeros_(self.conv_logits.bias)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """roi_feats (N, C, s, s) -> mask logits (N, classes, 2s, 2s)."""
        x = roi_feats
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x)))


def _box_slice(box, h: int, w: int) -> tuple[int, int, int, int]:
    """A float box's pixel window: floor / ceil, inside the image, at least
    one pixel (the JAX package's rule)."""
    x1, y1, x2, y2 = box[:4]
    x1 = int(np.clip(np.floor(x1), 0, w - 1))
    y1 = int(np.clip(np.floor(y1), 0, h - 1))
    x2 = int(np.clip(np.ceil(x2), x1 + 1, w))
    y2 = int(np.clip(np.ceil(y2), y1 + 1, h))
    return x1, y1, x2, y2


def gt_mask_crop(mask_u8: torch.Tensor, bbox,
                 crop_size: int = GT_MASK_CROP_SIZE) -> torch.Tensor:
    """One GT mask (H, W) cropped to ``bbox`` (host floats) and resized to
    (M, M) f32 on the mask's device."""
    h, w = mask_u8.shape[:2]
    x1, y1, x2, y2 = _box_slice(bbox, h, w)
    crop = mask_u8[y1:y2, x1:x2].to(torch.float32)
    return resize_linear_f32(crop[..., None], crop_size, crop_size)[..., 0]


@torch.no_grad()
def mask_targets_from_crops(mask_crops, gt_bboxes, rois, batch_idx,
                            assigned_gt, mask_size: int = 28) -> torch.Tensor:
    """Each RoI's binary target (N, S, S) f32 from its assigned GT's crop.

    mask_crops (B, K, M, M) in [0, 1]; gt_bboxes (B, K, 4) in the input
    image's coordinates; rois (N, 4) there too; batch_idx, assigned_gt
    (N,) int64 (a negative index reads GT 0: its target is not used)."""
    b, k, m, _ = mask_crops.shape
    crops = F.pad(mask_crops.reshape(b * k, 1, m, m).to(torch.float32),
                  (1, 1, 1, 1))
    crop_idx = batch_idx * k + assigned_gt.clamp(0, k - 1)
    gt = gt_bboxes.reshape(b * k, 4)[crop_idx]
    one = gt.new_ones(())
    gw = torch.maximum(gt[:, 2] - gt[:, 0], one)
    gh = torch.maximum(gt[:, 3] - gt[:, 1], one)
    # m / gw as a division of tensors: a python numerator would take a
    # reciprocal and a product, which round otherwise than JAX's division
    sx = torch.full_like(gw, float(m)) / gw
    sy = torch.full_like(gh, float(m)) / gh
    big = 4.0 * m
    # each corner relative to the GT box's top-left, in crop pixels
    corners = [((rois[:, i] - gt[:, i % 2]) * s).clamp(-big, big) + 1.0
               for i, s in ((0, sx), (1, sy), (2, sx), (3, sy))]
    flat = torch.stack([crop_idx.to(torch.float32), *corners], dim=1)
    sampled = roi_align(crops, flat, out_size=(mask_size, mask_size),
                        spatial_scale=1.0, sampling_ratio=2)[:, 0]
    return (sampled >= 0.5).to(torch.float32)


def mask_head_loss(mask_logits, targets, labels, pos_weight,
                   num_classes: int) -> torch.Tensor:
    """Binary cross-entropy of each positive RoI's assigned-class logits.

    mask_logits (N, C, S, S); targets (N, S, S) in {0, 1}; labels (N,);
    pos_weight (N,) f32, 1 on the positives."""
    s = mask_logits.shape[-1]
    cls = labels.clamp(0, num_classes - 1)
    logit = torch.gather(mask_logits, 1,
                         cls[:, None, None, None].expand(-1, 1, s, s))[:, 0]
    per_px = (torch.maximum(logit, logit.new_zeros(())) - logit * targets
              + torch.log1p(torch.exp(-logit.abs())))
    num_pos = torch.clamp_min(pos_weight.sum(), 1.0)
    return (per_px.mean((1, 2)) * pos_weight).sum() / num_pos


def select_positive_rois(rois, labels, assigned, is_pos, max_pos: int):
    """The first ``max_pos`` of each image's sampled RoIs with the positives
    first (a stable sort): rois (B, max_pos, 4), labels, assigned, is_pos."""
    order = torch.sort((~is_pos).to(torch.uint8), dim=1,
                       stable=True).indices[:, :max_pos]
    take = lambda x: torch.gather(x, 1, order)  # noqa: E731
    return (torch.gather(rois, 1, order[..., None].expand(-1, -1, 4)),
            take(labels), take(assigned), take(is_pos))


def paste_masks(mask_probs: torch.Tensor, boxes, img_h: int, img_w: int,
                thr: float = 0.5) -> torch.Tensor:
    """(N, img_h, img_w) uint8 binary masks on the probabilities' device:
    each (S, S) probability map resized to its box (host (N, >=4) floats in
    the original image's coordinates) and thresholded at ``thr``."""
    n = len(mask_probs)
    out = torch.zeros((n, img_h, img_w), dtype=torch.uint8,
                      device=mask_probs.device)
    for i in range(n):
        x1, y1, x2, y2 = _box_slice(boxes[i], img_h, img_w)
        m = resize_linear_f32(mask_probs[i].to(torch.float32)[..., None],
                              y2 - y1, x2 - x1)[..., 0]
        out[i, y1:y2, x1:x2] = m >= thr
    return out
