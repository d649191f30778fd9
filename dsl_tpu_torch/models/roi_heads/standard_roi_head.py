"""Standard RoI head (``Shared2FCBBoxHead``, ``Shared4Conv1FCBBoxHead``)
for the two-stage detectors.

Counterpart of ``dsl_tpu/models/roi_heads/standard_roi_head.py`` in the
form Faster R-CNN runs it:

- ``Shared2FCBBoxHead``: two shared FCs with relu, ``fc_cls`` over C+1
  classes and a class-specific ``fc_reg`` of 4C outputs, or with
  ``reg_class_agnostic`` (the Cascade R-CNN stages) one of 4 (mmdet's
  names ``shared_fcs.i``, ``fc_cls``, ``fc_reg``). It reads NCHW RoI features flattened
  (c, h, w), mmdet's order; the JAX package flattens NHWC (h, w, c), and
  the weight bridge permutes ``shared_fc0``'s input rows;
- ``Shared4Conv1FCBBoxHead`` (the gn+ws configs'): four shared 3x3 convs
  (``conv_cfg`` ConvWS, ``norm_cfg`` GN, no bias under a norm; mmdet's
  ``shared_convs.i.conv`` / ``.gn``) with relu, then one shared FC;
- ``DeformRoIPoolPack`` / ``ModulatedDeformRoIPoolPack`` (the dpool and
  mdpool configs' ``roi_pool_pack``, one for all levels as in the JAX
  package): mmcv's ``offset_fc`` (three FCs, the last zero at the start)
  on the plain-pooled features gives each bin's (dx, dy), and the
  modulated one's ``mask_fc`` (two FCs, the last zero at the start, then
  a sigmoid) each bin's weight; the FCs read (c, h, w) and ``offset_fc``
  writes (2, h, w), mmcv's orders (the weight bridge permutes the JAX
  package's (h, w, c) and (h, w, 2));
  ``extract_roi_feats`` with ``pack`` re-pools each RoI from its level at
  the learned shifts (``ops/roi_align.deform_roi_align_rows``) and weighs
  the bins by the mask;
- ``map_rois_to_levels`` (``floor(log2(sqrt(area) / 56 + 1e-6))`` clipped
  to the first 4 levels) and ``extract_roi_feats``, which gathers each RoI
  from its own level in one pass over a row table of the levels
  (``ops/roi_align.py``). JAX runs every RoI through every level and keeps
  the assigned level's result by a 0/1 mask, which gives the same sum;
- ``sample_rois`` / ``sample_batch_rois``: MaxIoU assignment of the
  proposals (0.5 / 0.5 / 0.5, no low-quality match), the GT boxes added
  as candidates, then ``num_samples`` RoIs at 1:3 by priority (positives
  first, capped, ranked by draw; negatives by ``1e6 + draw``; f32 ties to
  the lower index, as JAX's stable ``argsort``). The draws are an argument
  (B, P+K), so a test can hand it the JAX package's;
- ``roi_head_loss`` / ``rcnn_bbox_loss``: softmax CE over the valid
  samples and L1 (or SmoothL1) on the positives' class deltas (the one
  4-vector of a class-agnostic head), both over
  the valid count, and ``acc``; with ``reg_decoded_bbox`` or an IoU-family
  loss (IoU, GIoU, BoundedIoU) the loss compares the decoded boxes with
  the GT boxes instead;
- ``loss_cls=dict(type='SeesawLoss')`` (the Seesaw configs'): ``fc_cls``
  has C + 2 outputs (the classes, then positive and negative objectness);
  the loss gives ``loss_cls`` (the Seesaw CE of the positives, on
  ``batch["cum_samples"]``, the train loop's counts, or ones) and
  ``loss_cls_objectness`` (``core/losses.py::seesaw_loss``; its
  ``loss_weight`` is not read, as in the JAX package); predict scores each
  class by its softmax over the C classes times the positive objectness
  (the split activation);
- ``roi_head_predict`` / ``rcnn_decode_nms``: softmax, the per-class
  decode from the proposals (a class-agnostic head's one box for every
  class), clip, rescale, and ``multiclass_nms`` with per-class boxes (one
  launch of the NMS kernel for the batch).

Variants the JAX module also holds raise ``NotImplementedError`` naming
themselves: the cls-only head (Grid R-CNN), SABL,
generic RoI extraction, MSE and the DIoU / CIoU losses, OHEM and the
instance-balanced / IoU-balanced samplers, soft-NMS.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import HEADS
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.assigners import max_iou_assign_single
from dsl_tpu_torch.core.boxes import clip_to_shapes, resolve_delta_coder
from dsl_tpu_torch.core.nms import _gather_rows, multiclass_nms
from dsl_tpu_torch.models.layers import he_normal_, make_conv, make_norm
from dsl_tpu_torch.ops.roi_align import deform_roi_align_rows, roi_align_rows


class _BBoxHead(nn.Module):
    """What the two bbox heads share: the options, ``fc_cls`` / ``fc_reg``
    on ``fc_channels`` features and mmdet's init of the FCs."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int,
                 fc_channels: int, target_means: Sequence[float],
                 target_stds: Sequence[float], with_reg: bool,
                 reg_class_agnostic: bool, roi_extractor: str,
                 loss_cls: dict | None, loss_bbox: dict | None,
                 reg_decoded_bbox: bool, bbox_coder: dict | None,
                 roi_aligned: bool):
        super().__init__()
        for flag, what in ((not with_reg, "with_reg=False (Grid R-CNN)"),
                           (roi_extractor != "single",
                            f"roi_extractor={roi_extractor!r}"),
                           (dict(loss_cls or {}).get("type", "CrossEntropyLoss")
                            not in ("CrossEntropyLoss", "SeesawLoss"),
                            f"loss_cls {dict(loss_cls or {}).get('type')}")):
            if flag:
                raise NotImplementedError(
                    f"{type(self).__name__} {what} is not ported yet")
        resolve_rcnn_bbox_loss(loss_bbox)           # an unported loss raises
        resolve_delta_coder(bbox_coder)
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.roi_size = roi_size
        self.reg_class_agnostic = reg_class_agnostic
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.loss_cls = loss_cls
        self.loss_bbox = loss_bbox
        self.reg_decoded_bbox = reg_decoded_bbox
        self.bbox_coder = bbox_coder
        self.roi_aligned = roi_aligned
        self.seesaw = is_seesaw(self)
        self.fc_cls = nn.Linear(fc_channels,
                                num_classes + (2 if self.seesaw else 1))
        self.fc_reg = nn.Linear(fc_channels,
                                4 if reg_class_agnostic else num_classes * 4)

    def init_weights(self, generator: torch.Generator | None = None):
        """mmdet's: Xavier-uniform shared FCs, normal 0.01 / 0.001
        classifier and regressor, zero biases."""
        for fc in self.shared_fcs:
            nn.init.xavier_uniform_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)
        for fc, std in ((self.fc_cls, 0.01), (self.fc_reg, 0.001)):
            nn.init.normal_(fc.weight, 0.0, std, generator=generator)
            nn.init.zeros_(fc.bias)

    def _fcs(self, x: torch.Tensor):
        x = x.reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


@HEADS.register
class Shared2FCBBoxHead(_BBoxHead):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_size: int = 7, fc_channels: int = 1024,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 with_reg: bool = True, reg_class_agnostic: bool = False,
                 roi_extractor: str = "single", loss_cls: dict | None = None,
                 loss_bbox: dict | None = None, reg_decoded_bbox: bool = False,
                 bbox_coder: dict | None = None, roi_aligned: bool = True):
        super().__init__(num_classes, in_channels, roi_size, fc_channels,
                         target_means, target_stds, with_reg,
                         reg_class_agnostic, roi_extractor, loss_cls,
                         loss_bbox, reg_decoded_bbox, bbox_coder, roi_aligned)
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_channels),
            nn.Linear(fc_channels, fc_channels)])

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (N, C, s, s) -> (cls_logits (N, C+1), deltas (N, 4C),
        or (N, 4) class-agnostic)."""
        return self._fcs(roi_feats)


class _SharedConv(nn.Module):
    """mmcv ``ConvModule``: conv, optional norm (``gn``), relu."""

    def __init__(self, conv: nn.Conv2d, gn: nn.Module | None):
        super().__init__()
        self.conv = conv
        self.gn = gn

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x if self.gn is None else self.gn(x))


@HEADS.register
class Shared4Conv1FCBBoxHead(_BBoxHead):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_size: int = 7, conv_out_channels: int = 256,
                 fc_channels: int = 1024,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 with_reg: bool = True, reg_class_agnostic: bool = False,
                 roi_extractor: str = "single", loss_cls: dict | None = None,
                 loss_bbox: dict | None = None, reg_decoded_bbox: bool = False,
                 bbox_coder: dict | None = None, roi_aligned: bool = True,
                 conv_cfg: dict | None = None, norm_cfg: dict | None = None):
        super().__init__(num_classes, in_channels, roi_size, fc_channels,
                         target_means, target_stds, with_reg,
                         reg_class_agnostic, roi_extractor, loss_cls,
                         loss_bbox, reg_decoded_bbox, bbox_coder, roi_aligned)
        if norm_cfg is not None and norm_cfg.get("type") != "GN":
            raise NotImplementedError(
                f"Shared4Conv1FCBBoxHead norm {norm_cfg.get('type')} is not "
                f"ported yet: only GN")
        chans = [in_channels] + [conv_out_channels] * 4
        self.shared_convs = nn.ModuleList(
            _SharedConv(make_conv(conv_cfg, chans[i], chans[i + 1], 3,
                                  use_bias=norm_cfg is None),
                        None if norm_cfg is None
                        else make_norm(norm_cfg, chans[i + 1]))
            for i in range(4))
        self.shared_fcs = nn.ModuleList([
            nn.Linear(conv_out_channels * roi_size * roi_size, fc_channels)])

    def init_weights(self, generator: torch.Generator | None = None):
        super().init_weights(generator)
        for m in self.shared_convs.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (N, C, s, s) -> (cls_logits (N, C+1), deltas (N, 4C))."""
        x = roi_feats
        for conv in self.shared_convs:
            x = conv(x)
        return self._fcs(x)


@HEADS.register
class DeformRoIPoolPack(nn.Module):
    """The offset (and, ``modulated``, mask) predictor of deformable RoI
    pooling, mmcv's ``DeformRoIPoolPack`` / ``ModulatedDeformRoIPoolPack``
    FCs as the JAX package builds them: ``offset_fc`` FC-relu-FC-relu-FC to
    oh * ow * 2, ``mask_fc`` FC-relu-FC to oh * ow and a sigmoid, both on
    the (c, h, w)-flattened RoI features; the last FC of each zero at the
    start, so the pooling starts as RoIAlign's."""

    def __init__(self, output_size: int = 7, output_channels: int = 256,
                 deform_fc_channels: int = 1024, gamma: float = 0.1,
                 modulated: bool = False):
        super().__init__()
        self.output_size = output_size
        self.gamma = gamma
        self.modulated = modulated
        n_in = output_size * output_size * output_channels
        cells = output_size * output_size
        self.offset_fc = nn.Sequential(
            nn.Linear(n_in, deform_fc_channels), nn.ReLU(),
            nn.Linear(deform_fc_channels, deform_fc_channels), nn.ReLU(),
            nn.Linear(deform_fc_channels, cells * 2))
        self.mask_fc = (nn.Sequential(
            nn.Linear(n_in, deform_fc_channels), nn.ReLU(),
            nn.Linear(deform_fc_channels, cells), nn.Sigmoid())
            if modulated else None)

    def init_weights(self, generator: torch.Generator | None = None):
        """flax's default for the hidden FCs (the JAX package's init:
        LeCun normal, zero bias), zeros for the last of each branch."""
        for seq in (self.offset_fc, self.mask_fc):
            if seq is None:
                continue
            fcs = [m for m in seq if isinstance(m, nn.Linear)]
            for fc in fcs:
                std = (1.0 / fc.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(fc.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(fc.bias)
            nn.init.zeros_(fcs[-1].weight)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (N, C, s, s) -> (offsets (N, s, s, 2) as (dx, dy),
        mask (N, 1, s, s) or None)."""
        n, s = roi_feats.shape[0], self.output_size
        x = roi_feats.reshape(n, -1)
        off = self.offset_fc(x).reshape(n, 2, s, s).permute(0, 2, 3, 1)
        if self.mask_fc is None:
            return off, None
        return off, self.mask_fc(x).reshape(n, 1, s, s)


@HEADS.register
class ModulatedDeformRoIPoolPack(DeformRoIPoolPack):
    def __init__(self, **kwargs):
        kwargs.setdefault("modulated", True)
        super().__init__(**kwargs)


def is_seesaw(bbox_head) -> bool:
    """Whether the head's ``loss_cls`` is SeesawLoss (C + 2 logits)."""
    return dict(getattr(bbox_head, "loss_cls", None) or {}).get(
        "type") == "SeesawLoss"


def map_rois_to_levels(rois: torch.Tensor, num_levels: int,
                       finest_scale: int = 56) -> torch.Tensor:
    """FPN level per RoI (mmdet's single-level extractor formula)."""
    area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    scale = torch.sqrt(torch.maximum(area, area.new_full((), 1e-6)))
    # divided by a device tensor, as in roi_align's _axis_taps
    lvl = torch.floor(torch.log2(
        scale / scale.new_full((), float(finest_scale)) + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int64)


def _per_level(levels: torch.Tensor, values, dtype) -> torch.Tensor:
    """Each RoI's entry of ``values`` (one python number per level), made
    on the RoIs' device without a copy from the host."""
    out = torch.full(levels.shape, values[0], dtype=dtype, device=levels.device)
    for lvl, v in enumerate(values[1:], start=1):
        out = torch.where(levels == lvl, torch.full_like(out, v), out)
    return out


def level_table(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                strides: Sequence[int]):
    """The RoI levels (``feats[:4]``, NCHW) as one NHWC row table, and per
    RoI (N, 5) the arguments of ``roi_align_rows``: (table, base, height,
    width, spatial_scale) of the RoI's level."""
    num_levels = min(len(feats), 4)
    feats = feats[:num_levels]
    levels = map_rois_to_levels(rois[:, 1:5], num_levels)
    b = feats[0].shape[0]
    heights = [int(f.shape[2]) for f in feats]
    widths = [int(f.shape[3]) for f in feats]
    starts, row = [], 0
    for h, w in zip(heights, widths):
        starts.append(row)
        row += b * h * w
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])
                       for f in feats])
    height = _per_level(levels, heights, torch.int64)
    width = _per_level(levels, widths, torch.int64)
    bidx = rois[:, 0].to(torch.int64).clamp(0, b - 1)
    base = _per_level(levels, starts, torch.int64) + bidx * height * width
    scale = _per_level(levels, [1.0 / s for s in strides[:num_levels]],
                       rois.dtype)
    return table, base, height, width, scale


def extract_roi_feats(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      valid: torch.Tensor, strides: Sequence[int],
                      roi_size: int = 7, aligned: bool = True,
                      pack=None) -> torch.Tensor:
    """Multi-level RoIAlign (``sampling_ratio=2``): each RoI (N, 5)
    ``(batch_idx, x1, y1, x2, y2)`` from its level of ``feats[:4]`` (NCHW),
    in one gather over those levels' rows. With ``pack`` = (its forward,
    the ``DeformRoIPoolPack``), the deformable RoI pooling of the JAX
    package's ``_extract_for_head``: the pack on these features gives the
    bins' offsets (and mask), the RoIs are pooled again from their levels
    at those shifts (always aligned, as JAX's), times the mask. Returns
    (N, C, s, s)."""
    table, base, height, width, scale = level_table(feats, rois, strides)
    out = roi_align_rows(table, rois[:, 1:5], base, height, width, scale,
                         valid, (roi_size, roi_size), 2, aligned)
    out = out.permute(0, 3, 1, 2)
    if pack is None:
        return out
    pack_fn, pk = pack
    offsets, mask = pack_fn(out)
    out = deform_roi_align_rows(table, rois[:, 1:5], offsets, base, height,
                                width, scale, valid, (roi_size, roi_size), 2,
                                pk.gamma).permute(0, 3, 1, 2)
    return out if mask is None else out * mask


def resolve_rcnn_bbox_loss(cfg):
    """The bbox head's ``loss_bbox`` config -> ``(fn, decoded)``, ``fn(pred,
    target, pos_weight, avg_factor)``: L1 (the default, as every reference
    two-stage config), SmoothL1(beta) or Libra's BalancedL1(alpha, gamma,
    beta) on deltas; IoU, GIoU and
    BoundedIoU(beta) on decoded boxes (``decoded`` True); the others
    raise."""
    cfg = dict(cfg or {})
    t = cfg.get("type", "L1Loss")
    lw = float(cfg.get("loss_weight", 1.0))
    if t == "L1Loss":
        return (lambda p, tg, w, af: lw * L.l1_loss(
            p, tg, weight=w[:, None], avg_factor=af)), False
    if t == "SmoothL1Loss":
        beta = float(cfg.get("beta", 1.0))
        return (lambda p, tg, w, af: lw * L.smooth_l1_loss(
            p, tg, beta=beta, weight=w[:, None], avg_factor=af)), False
    if t == "BalancedL1Loss":
        beta = float(cfg.get("beta", 1.0))
        alpha = float(cfg.get("alpha", 0.5))
        gamma = float(cfg.get("gamma", 1.5))
        return (lambda p, tg, w, af: lw * L.balanced_l1_loss(
            p, tg, beta=beta, alpha=alpha, gamma=gamma, weight=w[:, None],
            avg_factor=af)), False
    if t in ("IoULoss", "GIoULoss"):
        fn = L.iou_loss if t == "IoULoss" else L.giou_loss
        return (lambda p, tg, w, af: lw * fn(p, tg, weight=w,
                                             avg_factor=af)), True
    if t == "BoundedIoULoss":
        beta = float(cfg.get("beta", 0.2))
        return (lambda p, tg, w, af: lw * L.bounded_iou_loss(
            p, tg, beta=beta, weight=w[:, None], avg_factor=af)), True
    raise NotImplementedError(f"rcnn loss_bbox {t} is not ported yet")


def sample_rois(uniform, proposals, prop_valid, gt_bboxes, gt_labels, gt_valid,
                num_classes: int, num_samples: int = 512,
                pos_fraction: float = 0.25, pos_iou_thr: float = 0.5,
                neg_iou_thr: float = 0.5, min_pos_iou: float = 0.5,
                match_low_quality: bool = False,
                add_gt_as_proposals: bool = True):
    """The fixed-shape RandomSampler over a batch.

    uniform (B, P+K) draws in [0, 1); proposals (B, P, 4), prop_valid
    (B, P); gt_* (B, K, ...). The proposals alone are assigned (the GT rows
    are then their own positives at IoU 1, as the reference adds them after
    assigning); the neutral band between the thresholds is never sampled.
    Returns rois (B, S, 4), labels, assigned, valid, is_pos, each (B, S),
    S = ``num_samples`` (padded with invalid rows where P+K < S).
    """
    gt_labels = gt_labels.to(torch.int64)
    b, p = prop_valid.shape
    k = gt_bboxes.shape[1]
    cand = torch.cat([proposals, gt_bboxes], dim=1)
    gt_as_cand = gt_valid if add_gt_as_proposals else torch.zeros_like(gt_valid)
    cand_valid = torch.cat([prop_valid, gt_as_cand], dim=1)
    labels_p, assigned_p, weights_p, _ = max_iou_assign_single(
        proposals, gt_bboxes, gt_labels, gt_valid, pos_iou_thr=pos_iou_thr,
        neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou,
        num_classes=num_classes, match_low_quality=match_low_quality)
    labels_g = torch.where(gt_as_cand, gt_labels,
                           torch.full_like(gt_labels, num_classes))
    arange = torch.arange(k, device=gt_labels.device).expand(b, k)
    assigned_g = torch.where(gt_as_cand, arange, torch.full_like(arange, -1))
    labels = torch.cat([labels_p, labels_g], dim=1)
    assigned = torch.cat([assigned_p, assigned_g], dim=1)
    neg_w = torch.cat([weights_p, weights_p.new_zeros((b, k))], dim=1)
    is_pos = (labels < num_classes) & cand_valid
    is_neg = (labels == num_classes) & (neg_w > 0) & cand_valid

    inf = uniform.new_full((), float("inf"))
    max_pos = int(num_samples * pos_fraction)
    pos_order = torch.sort(torch.where(is_pos, uniform, inf), dim=1,
                           stable=True).indices[:, :max_pos]
    within_cap = torch.zeros_like(is_pos).scatter_(1, pos_order, True)
    pos_take = is_pos & within_cap
    priority = torch.where(pos_take, uniform,
                           torch.where(is_neg, 1e6 + uniform, inf))
    order = torch.sort(priority, dim=1, stable=True).indices[:, :num_samples]
    take = lambda x: torch.gather(x, 1, order)  # noqa: E731
    out = dict(rois=_gather_rows(cand, order), labels=take(labels),
               assigned=take(assigned), valid=take(pos_take | is_neg),
               is_pos=take(pos_take))
    pad = num_samples - cand.shape[1]
    if pad > 0:
        fills = dict(rois=0.0, labels=num_classes, assigned=-1, valid=False,
                     is_pos=False)
        out = {key: torch.cat([v, torch.full((b, pad, *v.shape[2:]),
                                             fills[key], dtype=v.dtype,
                                             device=v.device)], dim=1)
               for key, v in out.items()}
    return out


def sample_batch_rois(proposals, prop_valid, batch: dict, uniform,
                      num_classes: int, **kw) -> dict:
    """:func:`sample_rois` on a batch's GT; ``kw`` as
    ``two_stage.parse_rcnn_train_cfg`` gives it."""
    return sample_rois(uniform, proposals, prop_valid, batch["gt_bboxes"],
                       batch["gt_labels"], batch["gt_valid"], num_classes,
                       **kw)


def flat_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, S, 4) -> (B*S, 5) rows ``(batch_idx, x1, y1, x2, y2)``."""
    b, s = boxes.shape[:2]
    bidx = torch.arange(b, device=boxes.device, dtype=boxes.dtype)
    return torch.cat([bidx[:, None, None].expand(b, s, 1), boxes],
                     dim=2).reshape(-1, 5)


def select_reg_deltas(bbox_head, reg: torch.Tensor, labels: torch.Tensor):
    """Each RoI's regressed 4-vector for its class (labels clipped to
    [0, C-1], so a background RoI reads class C-1's); a class-agnostic
    head's one 4-vector."""
    if bbox_head.reg_class_agnostic:
        return reg.reshape(-1, 4)
    nc = bbox_head.num_classes
    cls_idx = labels.clamp(0, nc - 1)
    return torch.gather(reg.reshape(-1, nc, 4), 1,
                        cls_idx[:, None, None].expand(-1, 1, 4))[:, 0]


def rcnn_bbox_loss(bbox_head, cls_logits, reg, samples: dict, batch: dict):
    """The bbox head's losses on the sampled RoIs: CE over C+1 averaged by
    the valid samples; the positives' class deltas against the encoded GT
    (L1 by default; with ``reg_decoded_bbox`` or an IoU-family loss their
    decoded boxes against the GT boxes), also over the valid count; and
    ``acc``."""
    labels = samples["labels"].reshape(-1)
    valid_f = samples["valid"].reshape(-1).to(torch.float32)
    pos_f = samples["is_pos"].reshape(-1).to(torch.float32)
    num_valid = torch.clamp_min(valid_f.sum(), 1.0)
    cls_cfg = dict(bbox_head.loss_cls or {})
    out = {}
    if is_seesaw(bbox_head):
        nc = bbox_head.num_classes
        cum = batch.get("cum_samples")
        if cum is None:
            cum = torch.ones((nc + 1,), dtype=torch.float32,
                             device=cls_logits.device)
        loss_cls, out["loss_cls_objectness"], _ = L.seesaw_loss(
            cls_logits, labels, cum, nc, p=float(cls_cfg.get("p", 0.8)),
            q=float(cls_cfg.get("q", 2.0)), weight=valid_f,
            avg_factor=num_valid)
    else:
        loss_cls = float(cls_cfg.get("loss_weight", 1.0)) * L.cross_entropy(
            cls_logits, labels, weight=valid_f, avg_factor=num_valid)
    gt = _gather_rows(batch["gt_bboxes"],
                      samples["assigned"].clamp_min(0)).reshape(-1, 4)
    enc, dec, means, stds = resolve_delta_coder(
        bbox_head.bbox_coder, bbox_head.target_means, bbox_head.target_stds)
    loss_fn, decoded = resolve_rcnn_bbox_loss(bbox_head.loss_bbox)
    rois = samples["rois"].reshape(-1, 4)
    reg_sel = select_reg_deltas(bbox_head, reg, labels)
    if decoded or bbox_head.reg_decoded_bbox:
        loss_reg = loss_fn(dec(rois, reg_sel, means, stds), gt, pos_f,
                           num_valid)
    else:
        loss_reg = loss_fn(reg_sel, enc(rois, gt, means, stds), pos_f,
                           num_valid)
    acc = ((cls_logits.argmax(-1) == labels).to(torch.float32)
           * valid_f).sum() / num_valid
    return dict(loss_cls=loss_cls, acc=acc, **out, loss_bbox=loss_reg)


def roi_head_loss(bbox_head, head_fn, feats, samples: dict, batch: dict,
                  strides: Sequence[int], pack=None) -> dict:
    """Extract the sampled RoIs' features (deformably with ``pack``, as
    :func:`extract_roi_feats` takes it), run the bbox head (``head_fn``,
    the head itself or a functional call of it), and its losses."""
    roi_feats = extract_roi_feats(feats, flat_rois(samples["rois"]),
                                  samples["valid"].reshape(-1), strides,
                                  bbox_head.roi_size, bbox_head.roi_aligned,
                                  pack)
    cls_logits, reg = head_fn(roi_feats)
    return rcnn_bbox_loss(bbox_head, cls_logits, reg, samples, batch)


def split_scores(bbox_head, cls_logits: torch.Tensor) -> torch.Tensor:
    """(N, C) class scores: the softmax over C+1 less the background, or
    under SeesawLoss the softmax over the C classes times the softmax of
    the 2 objectness logits' positive (mmdet's ``get_activation``)."""
    nc = bbox_head.num_classes
    if not is_seesaw(bbox_head):
        return torch.softmax(cls_logits, -1)[:, :nc]
    obj = torch.softmax(cls_logits[:, nc:], -1)
    return torch.softmax(cls_logits[:, :nc], -1) * obj[:, 0:1]


def rcnn_decode_nms(bbox_head, cls_logits, reg, proposals, prop_valid,
                    img_shapes=None, scale_factors=None,
                    score_thr: float = 0.05, iou_threshold: float = 0.5,
                    max_per_img: int = 100, nms_cfg: dict | None = None):
    """Softmax over C+1 (under SeesawLoss the softmax over the C classes
    times the positive objectness), the per-class decode from the
    proposals, clip to ``img_shapes``, divide by ``scale_factors``,
    multiclass NMS with per-class boxes over the valid proposals.

    cls_logits (B*P, C+1) (C+2 under SeesawLoss), reg (B*P, 4C) or
    class-agnostic (B*P, 4),
    proposals (B, P, 4), prop_valid (B, P). Returns dets (B, max_per_img,
    5), labels, valid."""
    ncfg = dict(nms_cfg or {})
    if ncfg.get("type", "nms") != "nms":
        raise NotImplementedError(f"rcnn nms type {ncfg.get('type')!r} is "
                                  f"not ported yet")
    nc = bbox_head.num_classes
    b, p = proposals.shape[:2]
    scores = split_scores(bbox_head, cls_logits).reshape(b, p, nc)
    _, dec, means, stds = resolve_delta_coder(
        bbox_head.bbox_coder, bbox_head.target_means, bbox_head.target_stds)
    reg = (reg.reshape(-1, 1, 4).expand(-1, nc, 4)
           if bbox_head.reg_class_agnostic else reg.reshape(-1, nc, 4))
    boxes = dec(proposals.reshape(-1, 1, 4).expand(-1, nc, 4), reg, means,
                stds).reshape(b, p, nc, 4)
    if img_shapes is not None:
        boxes = clip_to_shapes(boxes, img_shapes)
    if scale_factors is not None:
        boxes = boxes / scale_factors[:, None, None, :]
    return multiclass_nms(
        boxes, scores, score_thr=score_thr,
        iou_threshold=float(ncfg.get("iou_threshold", iou_threshold)),
        max_per_img=max_per_img, valid=prop_valid)


def roi_head_predict(bbox_head, head_fn, feats, proposals, prop_valid,
                     img_shapes=None, scale_factors=None,
                     strides: Sequence[int] = (4, 8, 16, 32),
                     score_thr: float = 0.05, iou_threshold: float = 0.5,
                     max_per_img: int = 100, nms_cfg: dict | None = None,
                     pack=None):
    """Every proposal's features (deformably with ``pack``), the bbox head
    (``head_fn``), then :func:`rcnn_decode_nms`."""
    roi_feats = extract_roi_feats(feats, flat_rois(proposals),
                                  prop_valid.reshape(-1), strides,
                                  bbox_head.roi_size, bbox_head.roi_aligned,
                                  pack)
    cls_logits, reg = head_fn(roi_feats)
    return rcnn_decode_nms(bbox_head, cls_logits, reg, proposals, prop_valid,
                           img_shapes=img_shapes, scale_factors=scale_factors,
                           score_thr=score_thr, iou_threshold=iou_threshold,
                           max_per_img=max_per_img, nms_cfg=nms_cfg)
