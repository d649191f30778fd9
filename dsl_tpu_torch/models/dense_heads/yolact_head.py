"""YOLACT: the box head with mask coefficients, the protonet, the segm
head, their loss and the predict.

Counterpart of ``dsl_tpu/models/dense_heads/yolact_head.py``, NCHW
modules:

- ``YOLACTHead``: ``num_head_convs`` 3x3 convs with relu shared by the
  levels, then per level ``conv_cls`` (A x (C + 1), softmax with the
  background last), ``conv_reg`` (A x 4) and ``conv_coeff`` (A x
  ``num_protos``, tanh), each returned NHWC per level as the JAX head's
  (mmdet's names ``head_convs.i.conv``, ``conv_cls``, ``conv_reg``,
  ``conv_coeff``);
- ``YOLACTProtonet``: on P3, three 3x3 convs with relu, a 2x bilinear
  upsample (``jax.image.resize``'s, ``ops/resize.py``), a 3x3 conv with
  relu and a 1x1 to ``num_protos`` with relu, held in mmdet's
  ``protonet`` ``Sequential`` (its indices count the relus and the
  upsample: the convs are ``protonet.0, 2, 4, 8, 10``); returns NCHW;
- ``YOLACTSegmHead``: a 1x1 ``segm_conv`` of a logit per class (train
  only), NCHW;
- ``paste_gt_crops`` (each GT's normalized mask crop pasted back at its
  box onto a canvas spanning the input, by bilinear sampling at the
  canvas pixels' centres; HTC's semantic target reads it too),
  ``_bilinear_1ch`` and ``_crop_mask`` (a mask zeroed outside its box
  grown by a canvas pixel, in the padded canvas's frame);
- ``yolact_loss``: MaxIoU (0.5 / 0.4, the GT's one best anchor forced),
  softmax CE with 3:1 hard negatives (OHEM), SmoothL1 x 1.5 on the
  positives; the protonet's BCE over the first ``max_masks_to_train``
  positives (a stable sort of the 0/1 positive flags, the lower index
  first as ``jax.lax.top_k``), each instance's mean over the proto map
  divided by its box's share of the image, times ``loss_mask_weight``;
  the segm head's BCE against each class's union of the pasted GT masks;
  a batch without ``gt_mask_crops`` raises ``KeyError`` naming it, as the
  JAX loss does;
- ``yolact_predict``: each level's ``nms_pre`` best anchors (stable), the
  decode, ``core/nms.py::fast_nms`` (no NMS kernel), the kept
  detections' masks (sigmoid of the prototypes times their coefficients)
  cropped to their boxes and resampled to ``mask_crop_size`` (56) crops
  at the boxes, for the host's paste; ``yolact_full_predict`` runs the
  detector first.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.func import functional_call

from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.anchors import AnchorGenerator
from dsl_tpu_torch.core.assigners import max_iou_assign
from dsl_tpu_torch.core.boxes import bbox2delta, delta2bbox
from dsl_tpu_torch.core.nms import _gather_rows, _sort_desc, fast_nms
from dsl_tpu_torch.models.dense_heads.retina_head import _Conv
from dsl_tpu_torch.models.layers import normal_init
from dsl_tpu_torch.ops.resize import resize_bilinear
from dsl_tpu_torch.parallel.mesh import all_reduce_sum
from dsl_tpu_torch.registry import HEADS


def _bilinear_1ch(img: torch.Tensor, ys: torch.Tensor,
                  xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (..., H, W) images at float coordinates (..., h,
    w), the corners clipped into the image and the weights into [0, 1]."""
    h, w = img.shape[-2:]
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)
    wx = (xs - x0).clamp(0.0, 1.0)
    flat = img.reshape(*img.shape[:-2], h * w)

    def at(yi, xi):
        idx = (yi.to(torch.int64) * w + xi.to(torch.int64))
        return torch.gather(flat, -1, idx.reshape(*idx.shape[:-2], -1)
                            ).reshape(idx.shape)

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def paste_gt_crops(crops: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, out_hw, img_hw) -> torch.Tensor:
    """crops (..., K, M, M) in [0, 1], boxes (..., K, 4) in the input
    image's pixels (``img_hw``), valid (..., K) -> (..., K, h, w)."""
    h, w = out_hw
    ih, iw = img_hw
    m = crops.shape[-1]
    dev = boxes.device
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (ih / h)
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (iw / w)
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    floor = boxes.new_full((), 1e-3)
    ny = (py - y1) / torch.maximum(y2 - y1, floor)          # (..., K, h)
    nx = (px - x1) / torch.maximum(x2 - x1, floor)          # (..., K, w)
    inside = (((ny >= 0) & (ny <= 1))[..., :, None]
              & ((nx >= 0) & (nx <= 1))[..., None, :])
    sy = (ny * m - 0.5)[..., :, None].expand(*ny.shape, w)
    sx = (nx * m - 0.5)[..., None, :].expand(*nx.shape[:-1], h, w)
    vals = _bilinear_1ch(crops.to(torch.float32), sy, sx)
    vals = torch.where(inside, vals, vals.new_zeros(()))
    return vals * valid.to(torch.float32)[..., None, None]


@HEADS.register
class YOLACTHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, num_head_convs: int = 1,
                 num_protos: int = 32,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 3, scales_per_octave: int = 1,
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                 neg_pos_ratio: int = 3, max_masks_to_train: int = 100,
                 anchor_generator: dict | None = None,
                 loss_cls: dict | None = None, loss_bbox: dict | None = None,
                 use_ohem: bool = True):
        super().__init__()
        cls_cfg, bbox_cfg = dict(loss_cls or {}), dict(loss_bbox or {})
        for flag, what in (
                (not use_ohem, "use_ohem=False"),
                (cls_cfg.get("type", "CrossEntropyLoss") != "CrossEntropyLoss"
                 or cls_cfg.get("use_sigmoid", False),
                 f"loss_cls {cls_cfg.get('type')}"),
                (bbox_cfg.get("type", "SmoothL1Loss") != "SmoothL1Loss",
                 f"loss_bbox {bbox_cfg.get('type')}")):
            if flag:
                raise NotImplementedError(f"YOLACTHead {what} is not ported "
                                          f"(nor built in the JAX package)")
        self.num_classes = num_classes
        self.num_protos = num_protos
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.neg_pos_ratio = neg_pos_ratio
        self.max_masks_to_train = max_masks_to_train
        self.loss_cls = cls_cfg
        self.loss_bbox = bbox_cfg
        # the four keys the JAX head reads of ``anchor_generator``
        gen = dict(anchor_generator or {})
        self.anchors = AnchorGenerator(
            strides=gen.get("strides", list(strides)),
            ratios=gen.get("ratios", list(anchor_ratios)),
            octave_base_scale=gen.get("octave_base_scale", octave_base_scale),
            scales_per_octave=gen.get("scales_per_octave", scales_per_octave))
        na = len(anchor_ratios) * scales_per_octave
        chans = [in_channels] + [feat_channels] * num_head_convs
        self.head_convs = nn.ModuleList(_Conv(chans[i], chans[i + 1])
                                        for i in range(num_head_convs))
        self.conv_cls = nn.Conv2d(feat_channels, na * (num_classes + 1), 3,
                                  padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, na * 4, 3, padding=1)
        self.conv_coeff = nn.Conv2d(feat_channels, na * num_protos, 3,
                                    padding=1)

    def init_weights(self, generator: torch.Generator | None = None):
        """Xavier-uniform shared convs (mmdet's), normal 0.01 predictors
        (the JAX head's), zero biases."""
        for conv in self.head_convs:
            nn.init.xavier_uniform_(conv.conv.weight, generator=generator)
            nn.init.zeros_(conv.conv.bias)
        for conv in (self.conv_cls, self.conv_reg, self.conv_coeff):
            normal_init(conv, 0.01, generator=generator)

    def forward(self, feats, training: bool = False):
        """NCHW levels -> (cls_scores, bbox_preds, coeff_preds), tuples of
        NHWC tensors of A(C+1), 4A and A * ``num_protos`` channels."""
        cls_scores, bbox_preds, coeff_preds = [], [], []
        for x in feats:
            for conv in self.head_convs:
                x = conv(x)
            cls_scores.append(self.conv_cls(x).permute(0, 2, 3, 1))
            bbox_preds.append(self.conv_reg(x).permute(0, 2, 3, 1))
            coeff_preds.append(torch.tanh(self.conv_coeff(x)).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds), tuple(coeff_preds)


class _Upsample2x(nn.Module):
    """The protonet's 2x bilinear upsample (mmdet's ``InterpolateModule``),
    as ``jax.image.resize`` computes it."""

    def forward(self, x):
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


@HEADS.register
class YOLACTProtonet(nn.Module):
    def __init__(self, num_protos: int = 32, in_channels: int = 256,
                 proto_channels: Sequence[int] = (256, 256, 256),
                 loss_mask_weight: float = 6.125):
        super().__init__()
        self.num_protos = num_protos
        self.loss_mask_weight = float(loss_mask_weight)
        layers, cin = [], in_channels
        for ch in proto_channels:
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
        layers += [_Upsample2x(), nn.ReLU(),
                   nn.Conv2d(cin, proto_channels[-1], 3, padding=1), nn.ReLU(),
                   nn.Conv2d(proto_channels[-1], num_protos, 1), nn.ReLU()]
        self.protonet = nn.Sequential(*layers)

    def init_weights(self, generator: torch.Generator | None = None):
        """Xavier-uniform convs (mmdet's), zero biases."""
        for m in self.protonet:
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """P3 (B, C, h, w) -> prototypes (B, num_protos, 2h, 2w)."""
        return self.protonet(x)


@HEADS.register
class YOLACTSegmHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.segm_conv = nn.Conv2d(in_channels, num_classes, 1)

    def init_weights(self, generator: torch.Generator | None = None):
        nn.init.xavier_uniform_(self.segm_conv.weight, generator=generator)
        nn.init.zeros_(self.segm_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """P3 (B, C, h, w) -> per-class logits (B, num_classes, h, w)."""
        return self.segm_conv(x)


def _crop_mask(masks: torch.Tensor, boxes: torch.Tensor, img_hw) -> torch.Tensor:
    """masks (..., h, w) on a grid spanning the canvas ``img_hw``, boxes
    (..., 4) in its pixels: zero outside each box grown by one grid pixel
    (mmdet's ``crop`` with ``padding=1``)."""
    h, w = masks.shape[-2:]
    ih, iw = img_hw
    dev = masks.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (ih / h)
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (iw / w)
    pad_y, pad_x = ih / h, iw / w
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    rows = (cy >= y1 - pad_y) & (cy < y2 + pad_y)             # (..., h)
    cols = (cx >= x1 - pad_x) & (cx < x2 + pad_x)             # (..., w)
    return masks * (rows[..., :, None] & cols[..., None, :])


def _bce_prob(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, 1e-4, 1 - 1e-4)
    return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def yolact_loss(head: YOLACTHead, outputs, batch: dict, group=None,
                mask_weight: float = 6.125) -> dict:
    """``loss_cls``, ``loss_bbox``, ``loss_mask`` and ``loss_segm`` of the
    detector's five outputs (the head's NHWC levels, the prototypes and the
    segm logits, NCHW); the positive and selected-instance counts are the
    global batch's (summed over ``group``'s ranks where there is one)."""
    cls_scores, bbox_preds, coeff_preds, protos, segm_pred = outputs
    nc = head.num_classes
    device = cls_scores[0].device
    sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    anchors = head.anchors.flat_anchors(sizes, device)
    labels, assigned, weights, _ = max_iou_assign(
        anchors, batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"],
        pos_iou_thr=head.pos_iou_thr, neg_iou_thr=head.neg_iou_thr,
        min_pos_iou=0.0, num_classes=nc, gt_max_assign_all=False)
    b, a = labels.shape
    flat_cls = torch.cat([c.reshape(b, -1, nc + 1) for c in cls_scores], 1)
    flat_reg = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], 1)
    flat_coeff = torch.cat([c.reshape(b, -1, head.num_protos)
                            for c in coeff_preds], 1)
    pos_f = (labels < nc).to(torch.float32)
    num_pos = torch.clamp_min(all_reduce_sum(pos_f.sum(), group), 1.0)

    # OHEM: the negatives harder than the (3 x positives)-th, per image
    ce = L.cross_entropy(flat_cls, labels, reduction="none")
    neg_mask = (labels == nc) & (weights > 0)
    neg_loss = torch.where(neg_mask, ce, ce.new_full((), -1e30))
    sorted_neg = torch.sort(neg_loss.detach(), dim=1, descending=True).values
    idx = (head.neg_pos_ratio * pos_f.sum(1)).to(torch.int64).clamp(1, a - 1)
    thresh = torch.gather(sorted_neg, 1, idx[:, None])
    keep_neg = neg_mask & (neg_loss > thresh)
    loss_cls = float(head.loss_cls.get("loss_weight", 1.0)) * (
        (ce * (pos_f + keep_neg.to(torch.float32))).sum() / num_pos)
    gi = assigned.clamp_min(0)
    tgt = bbox2delta(anchors[None], _gather_rows(batch["gt_bboxes"], gi),
                     head.target_means, head.target_stds)
    loss_bbox = float(head.loss_bbox.get("loss_weight", 1.5)) * L.smooth_l1_loss(
        flat_reg, tgt, beta=float(head.loss_bbox.get("beta", 1.0)),
        weight=pos_f[..., None], avg_factor=num_pos)
    losses = dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    img_hw = tuple(batch["images"].shape[2:4])
    ph, pw = protos.shape[2:4]
    crops = batch["gt_mask_crops"]                               # (B, K, M, M)
    m = crops.shape[-1]
    # the protonet's loss over the first positives, in anchor order
    sel_score, sel_idx = _sort_desc(pos_f, min(head.max_masks_to_train, a))
    sel_valid = sel_score > 0
    sel_coeff = _gather_rows(flat_coeff, sel_idx)
    sel_gt = torch.gather(gi, 1, sel_idx)
    sel_boxes = _gather_rows(batch["gt_bboxes"], sel_gt)
    n_sel = sel_idx.shape[1]
    sel_crops = torch.gather(crops, 1, sel_gt[..., None, None].expand(
        b, n_sel, m, m))
    mask_pred = torch.sigmoid(torch.einsum("bphw,bnp->bnhw", protos, sel_coeff))
    mask_pred = _crop_mask(mask_pred, sel_boxes, img_hw)
    targets = paste_gt_crops(sel_crops, sel_boxes, sel_valid, (ph, pw), img_hw)
    one = sel_boxes.new_ones(())
    bw = torch.maximum(sel_boxes[..., 2] - sel_boxes[..., 0], one) / img_hw[1]
    bh = torch.maximum(sel_boxes[..., 3] - sel_boxes[..., 1], one) / img_hw[0]
    per_inst = _bce_prob(mask_pred, targets).mean(dim=(2, 3)) / bw / bh
    sel_f = sel_valid.to(torch.float32)
    total_sel = torch.clamp_min(all_reduce_sum(sel_f.sum(), group), 1.0)
    losses["loss_mask"] = mask_weight * (per_inst * sel_f).sum() / total_sel

    # the segm head's loss: each class's union of its pasted GT masks
    sh, sw = segm_pred.shape[2:4]
    pasted = (paste_gt_crops(crops, batch["gt_bboxes"], batch["gt_valid"],
                             (sh, sw), img_hw) > 0.5).to(torch.float32)
    cls = batch["gt_labels"].to(torch.int64).clamp(0, nc - 1)
    segm_t = torch.zeros((b, nc, sh * sw), dtype=torch.float32,
                         device=device).scatter_reduce(
        1, cls[..., None].expand(-1, -1, sh * sw), pasted.reshape(b, -1, sh * sw),
        reduce="amax").reshape(b, nc, sh, sw)
    losses["loss_segm"] = L.binary_cross_entropy(
        segm_pred, segm_t, reduction="mean", avg_factor=float(b * sh * sw))
    return losses


@torch.no_grad()
def yolact_predict(head: YOLACTHead, outputs, img_shapes=None,
                   scale_factors=None, nms_pre: int = 1000,
                   score_thr: float = 0.05, iou_threshold: float = 0.5,
                   max_per_img: int = 100, mask_crop_size: int = 56,
                   img_hw=None):
    """Decode, fast NMS (top 200 per class) and the kept detections' mask
    crops: dets (B, M, 5) in the original frame (divided by
    ``scale_factors``), labels, valid, and each detection's (S, S)
    probabilities at its box, S = ``mask_crop_size``; ``img_hw`` the padded
    canvas's (H, W), whose frame the masks are cropped in (as the JAX
    function's; ``img_shapes`` is not read, as there)."""
    cls_scores, bbox_preds, coeff_preds, protos, _ = outputs
    nc = head.num_classes
    device = cls_scores[0].device
    lvl_anchors = head.anchors.grid_anchors(
        [tuple(c.shape[1:3]) for c in cls_scores], device)
    b = cls_scores[0].shape[0]
    boxes_all, scores_all, coeff_all = [], [], []
    for lvl, (cs, bp, cf) in enumerate(zip(cls_scores, bbox_preds,
                                           coeff_preds)):
        scores = torch.softmax(cs.reshape(b, -1, nc + 1), -1)[..., :nc]
        k = min(nms_pre, scores.shape[1])
        _, top = _sort_desc(scores.amax(-1), k)
        boxes_all.append(delta2bbox(lvl_anchors[lvl][top],
                                    _gather_rows(bp.reshape(b, -1, 4), top),
                                    head.target_means, head.target_stds))
        scores_all.append(_gather_rows(scores, top))
        coeff_all.append(_gather_rows(cf.reshape(b, -1, head.num_protos), top))
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    coeffs = torch.cat(coeff_all, 1)
    if img_hw is None:
        img_hw = (1e9, 1e9)
    dets, labels, box_idx, valid = fast_nms(
        boxes, scores, score_thr=score_thr, iou_threshold=iou_threshold,
        top_k=200, max_num=max_per_img)
    masks = torch.sigmoid(torch.einsum("bphw,bnp->bnhw", protos,
                                       _gather_rows(coeffs, box_idx)))
    masks = _crop_mask(masks, dets[..., :4], img_hw)
    crops = _crops_at_boxes(masks, dets[..., :4], img_hw, mask_crop_size)
    if scale_factors is not None:
        dets = torch.cat([dets[..., :4] / scale_factors[:, None, :],
                          dets[..., 4:]], dim=-1)
    return dets, labels, valid, crops


def _crops_at_boxes(masks: torch.Tensor, boxes: torch.Tensor, img_hw,
                    s: int) -> torch.Tensor:
    """masks (B, N, ph, pw) on a grid spanning ``img_hw`` resampled to (s,
    s) at the centres of each box's s x s cells -> (B, N, s, s)."""
    ph, pw = masks.shape[-2:]
    ih, iw = img_hw
    cell = (torch.arange(s, dtype=torch.float32, device=masks.device)
            + 0.5) / s
    floor = boxes.new_full((), 1e-3)
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    ys = (y1 + cell * torch.maximum(y2 - y1, floor)) * (ph / ih) - 0.5
    xs = (x1 + cell * torch.maximum(x2 - x1, floor)) * (pw / iw) - 0.5
    return _bilinear_1ch(masks, ys[..., :, None].expand(*ys.shape, s),
                         xs[..., None, :].expand(*xs.shape[:-1], s, s))


@torch.no_grad()
def yolact_full_predict(detector, images: torch.Tensor, img_shapes=None,
                        scale_factors=None, test_cfg: dict | None = None,
                        variables: dict | None = None):
    """The detector's forward (with ``variables``, name -> tensor, in place
    of its own where given), then :func:`yolact_predict` with the config's
    ``nms_pre``, ``score_thr``, IoU (``nms.iou_threshold``, else
    ``iou_thr``) and ``max_per_img``, on the padded canvas: dets, labels,
    valid and the 56x56 mask probabilities (the ``mask_rcnn_predict``
    contract). No launch of the NMS kernel."""
    outputs = (detector(images) if variables is None
               else functional_call(detector, variables, (images,)))
    tc = dict(test_cfg or detector.test_cfg or {})
    nms_cfg = dict(tc.get("nms", {}) or {})
    return yolact_predict(
        detector.bbox_head, outputs, img_shapes=img_shapes,
        scale_factors=scale_factors, nms_pre=tc.get("nms_pre", 1000),
        score_thr=tc.get("score_thr", 0.05),
        iou_threshold=nms_cfg.get("iou_threshold", tc.get("iou_thr", 0.5)),
        max_per_img=tc.get("max_per_img", 100),
        img_hw=tuple(images.shape[2:4]))
