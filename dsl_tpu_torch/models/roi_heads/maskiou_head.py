"""The MaskIoU head of Mask Scoring R-CNN, its targets and its loss.

Counterpart of ``dsl_tpu/models/roi_heads/maskiou_head.py``:

- ``MaskIoUHead``: the predicted mask's probabilities (N, 2S, 2S) max-pooled
  2x2 and concatenated after the mask RoI features (N, C, S, S); ``num_convs``
  3x3 convs with relu, the last at stride 2; two FCs with relu; ``fc_mask_iou``
  of one IoU per class (mmdet's names ``convs.i.conv``, ``fcs.i``,
  ``fc_mask_iou``). The FCs read the features flattened (c, h, w), mmdet's
  order; the JAX head flattens NHWC (h, w, c), and the weight bridge permutes
  ``fc0``'s input rows;
- ``gt_area_inside``: each RoI's assigned GT mask area inside the RoI (the
  RoI truncated to ints and clipped as ``BitmapMasks.crop`` does),
  integrated from the GT's normalized crop;
- ``mask_iou_target``: the IoU of the thresholded prediction with the whole
  instance: the target's area scaled by the instance's full area over its
  area inside the RoI (``gt_mask_areas`` of the batch);
- ``mask_iou_loss``: the MSE of the assigned class's predicted IoU over the
  RoIs whose target is above 0, weight 0.5.

As in the JAX package, predict does not use the head (no detection score is
rescaled by the predicted mask IoU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import HEADS


class _IoUConv(nn.Module):
    """mmcv ``ConvModule`` of a 3x3 conv and relu (``convs.i.conv``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=stride,
                              padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


@HEADS.register
class MaskIoUHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 4,
                 fc_out_channels: int = 1024, roi_feat_size: int = 14):
        super().__init__()
        self.num_classes = num_classes
        chans = [in_channels + 1] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList(
            _IoUConv(chans[i], chans[i + 1], 2 if i == num_convs - 1 else 1)
            for i in range(num_convs))
        pooled = (roi_feat_size + 1) // 2
        self.fcs = nn.ModuleList([
            nn.Linear(conv_out_channels * pooled * pooled, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_mask_iou = nn.Linear(fc_out_channels, num_classes)

    def init_weights(self, generator: torch.Generator | None = None):
        """mmdet's: Kaiming-normal convs, Kaiming-uniform FCs, normal 0.01
        ``fc_mask_iou``, zero biases."""
        for conv in self.convs:
            nn.init.kaiming_normal_(conv.conv.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            nn.init.zeros_(conv.conv.bias)
        for fc in self.fcs:
            nn.init.kaiming_uniform_(fc.weight, a=1, mode="fan_in",
                                     nonlinearity="leaky_relu",
                                     generator=generator)
            nn.init.zeros_(fc.bias)
        nn.init.normal_(self.fc_mask_iou.weight, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.fc_mask_iou.bias)

    def forward(self, mask_feats: torch.Tensor,
                mask_pred: torch.Tensor) -> torch.Tensor:
        """mask_feats (N, C, S, S); mask_pred (N, 2S, 2S) probabilities of
        the predicted class. Returns (N, num_classes) mask-IoU scores."""
        pooled = F.max_pool2d(mask_pred[:, None], 2, stride=2)
        x = torch.cat([mask_feats, pooled], dim=1)
        for conv in self.convs:
            x = conv(x)
        x = x.flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_mask_iou(x)


def gt_area_inside(crops, gt_boxes, rois, img_shapes) -> torch.Tensor:
    """Pixel area of each RoI's assigned GT mask inside the RoI.

    crops (N, M, M) the assigned GT's normalized crop; gt_boxes (N, 4) and
    rois (N, 4) in the input image's coordinates; img_shapes (N, 2) [h, w].
    The GT crop's window is its box floored and ceiled into the image (as
    the data layer crops it); the RoI is truncated to ints and clipped to
    [0, size], at least a pixel, as ``BitmapMasks.crop``; the crop's cell
    centres inside it are summed with their cell's pixel area."""
    m = crops.shape[-1]
    ih, iw = img_shapes[:, 0], img_shapes[:, 1]
    one = gt_boxes.new_ones(())
    zero = gt_boxes.new_zeros(())
    gx1 = torch.minimum(torch.maximum(torch.floor(gt_boxes[:, 0]), zero), iw - 1)
    gy1 = torch.minimum(torch.maximum(torch.floor(gt_boxes[:, 1]), zero), ih - 1)
    gx2 = torch.minimum(torch.maximum(torch.ceil(gt_boxes[:, 2]), gx1 + 1), iw)
    gy2 = torch.minimum(torch.maximum(torch.ceil(gt_boxes[:, 3]), gy1 + 1), ih)

    def trunc_clip(v, hi):
        return torch.minimum(torch.maximum(torch.trunc(v), zero), hi)

    px1 = trunc_clip(rois[:, 0], iw)
    py1 = trunc_clip(rois[:, 1], ih)
    px2 = torch.minimum(px1 + torch.maximum(trunc_clip(rois[:, 2], iw) - px1,
                                            one), iw)
    py2 = torch.minimum(py1 + torch.maximum(trunc_clip(rois[:, 3], ih) - py1,
                                            one), ih)
    gw, gh = gx2 - gx1, gy2 - gy1
    # divided by device tensors: a python divisor becomes a product by its
    # reciprocal on the card
    m_t = gw.new_full((), float(m))
    centres = torch.arange(m, device=gw.device, dtype=gw.dtype) + 0.5
    ax = gx1[:, None] + centres[None, :] * (gw[:, None] / m_t)
    ay = gy1[:, None] + centres[None, :] * (gh[:, None] / m_t)
    ux = ((ax >= px1[:, None]) & (ax < px2[:, None])).to(torch.float32)
    uy = ((ay >= py1[:, None]) & (ay < py2[:, None])).to(torch.float32)
    cell = (gw * gh) / (m_t * m_t)
    inside = (crops.to(torch.float32) * uy[:, :, None] * ux[:, None, :]).sum((1, 2))
    return inside * cell


@torch.no_grad()
def mask_iou_target(mask_pred, mask_targets, pos_weight, gt_full_areas,
                    crops, gt_boxes, rois, img_shapes,
                    mask_thr_binary: float = 0.5) -> torch.Tensor:
    """Each RoI's mask-IoU target (N,): the IoU of ``mask_pred`` (N, S, S)
    above ``mask_thr_binary`` with the target (N, S, S), whose area is
    scaled to the whole instance's (``gt_full_areas`` (N,) over the area
    inside the RoI, :func:`gt_area_inside` of the rest), times
    ``pos_weight``."""
    pred_bin = (mask_pred > mask_thr_binary).to(torch.float32)
    pred_area = pred_bin.sum((1, 2))
    inter = (pred_bin * mask_targets).sum((1, 2))
    inside = gt_area_inside(crops, gt_boxes, rois, img_shapes)
    ratio = inside / (gt_full_areas + 1e-7)
    gt_full = mask_targets.sum((1, 2)) / (ratio + 1e-7)
    denom = pred_area + gt_full - inter
    iou = torch.where(denom > 0, inter / torch.clamp_min(denom, 1e-7),
                      denom.new_zeros(()))
    return iou * pos_weight


def mask_iou_loss(iou_pred, labels, iou_target, pos_weight,
                  num_classes: int, loss_weight: float = 0.5) -> torch.Tensor:
    """MSE of each RoI's predicted IoU at its class (iou_pred (N, C),
    labels (N,)) against ``iou_target`` over the positives whose target is
    above 0, averaged over them, times ``loss_weight``."""
    cls = labels.clamp(0, num_classes - 1)
    p = torch.gather(iou_pred, 1, cls[:, None])[:, 0]
    sel = (iou_target > 0).to(torch.float32) * pos_weight
    num = torch.clamp_min(sel.sum(), 1.0)
    return loss_weight * ((p - iou_target) ** 2 * sel).sum() / num
