"""RPN head: class-agnostic anchor proposals for the two-stage detector.

Counterpart of ``dsl_tpu/models/dense_heads/rpn_head.py``: a 3x3 conv with
relu and 1x1 objectness / delta predictors shared over the FPN levels
(mmdet's names ``rpn_conv``, ``rpn_cls``, ``rpn_reg``; outputs NHWC per
level, the JAX package's layout, so that loss and decode flatten
(y, x, anchor) as it does); ``rpn_loss`` (MaxIoU 0.7 / 0.3 with
``min_pos_iou`` 0.3 and the low-quality match, the anchors outside an
image by more than ``allowed_border`` left out where that is >= 0 (the
standalone RPN configs' 0), a random subsample of 256 anchors at 1:1, BCE
and L1 (or SmoothL1, the cascade configs') both over the sampled count);
``rpn_proposals``
(per level the ``nms_pre`` best by score, decode and clip, the
``min_bbox_size`` filter, one NMS over the levels with each level's boxes
shifted apart, ``num_proposals`` padded outputs). The NMS of the whole
batch is one launch of the CUDA kernel.

The subsample's random draws are an argument (uniforms in [0, 1), one per
anchor), so a test can hand it the JAX package's draws; the train step
draws them from a ``torch.Generator`` seeded by the iteration
(``models/detectors/two_stage.py::sampler_draws``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import HEADS
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.anchors import anchor_generator_from_cfg
from dsl_tpu_torch.core.assigners import anchor_inside_flags, max_iou_assign
from dsl_tpu_torch.core.boxes import clip_to_shapes, resolve_delta_coder
from dsl_tpu_torch.core.nms import _gather_rows, nms
from dsl_tpu_torch.models.layers import normal_init


@HEADS.register
class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_scales: Sequence[float] = (8.0,),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3,
                 anchor_generator: dict | None = None,
                 bbox_coder: dict | None = None,
                 loss_cls: dict | None = None, loss_bbox: dict | None = None):
        super().__init__()
        cls_cfg = dict(loss_cls or {})
        if cls_cfg.get("type", "CrossEntropyLoss") != "CrossEntropyLoss" or \
                not cls_cfg.get("use_sigmoid", True):
            raise NotImplementedError(
                f"RPNHead loss_cls {cls_cfg}: only the sigmoid CrossEntropyLoss "
                f"is ported")
        self.strides = list(strides)
        self.anchor_scales = list(anchor_scales)
        self.anchor_ratios = list(anchor_ratios)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.bbox_coder = bbox_coder
        self.loss_cls = loss_cls
        self.loss_bbox = loss_bbox
        resolve_delta_coder(bbox_coder)            # an unknown coder raises here
        _check_rpn_bbox_loss(loss_bbox)
        self.anchors = anchor_generator_from_cfg(
            anchor_generator, strides=self.strides, ratios=self.anchor_ratios,
            scales=self.anchor_scales)
        num_anchors = self.anchors.num_base_anchors
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def init_weights(self, generator: torch.Generator | None = None):
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            normal_init(m, 0.01, generator=generator)

    def forward(self, feats, training: bool = False):
        """feats: NCHW FPN levels -> (scores, deltas), tuples of NHWC
        tensors with A and 4A channels."""
        scores, deltas = [], []
        for x in feats:
            h = F.relu(self.rpn_conv(x))
            scores.append(self.rpn_cls(h).permute(0, 2, 3, 1))
            deltas.append(self.rpn_reg(h).permute(0, 2, 3, 1))
        return tuple(scores), tuple(deltas)


def _smallest(priority: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest along the last axis, the lower index
    first among ties (``lax.top_k`` of the negation, as JAX ranks)."""
    return torch.sort(priority, dim=-1, stable=True).indices[..., :k]


def _take(mask: torch.Tensor, priority: torch.Tensor, k: int) -> torch.Tensor:
    idx = _smallest(priority, min(k, mask.shape[-1]))
    take = torch.zeros_like(mask).scatter_(-1, idx, True)
    return take & mask


def subsample_anchors(uniform: torch.Tensor, is_pos: torch.Tensor,
                      is_neg: torch.Tensor, num: int, pos_fraction: float):
    """Fixed-shape RandomSampler over dense anchors, per image: up to
    ``num * pos_fraction`` positives of the smallest draws, then negatives
    (ranked after every positive by ``1e6 + draw``, where f32 ties are
    many and broken by index) fill to ``num``.

    uniform, is_pos, is_neg (B, A). Returns the masks (pos_take, sel)."""
    inf = uniform.new_full((), float("inf"))
    pos_take = _take(is_pos, torch.where(is_pos, uniform, inf),
                     int(num * pos_fraction))
    pri = torch.where(pos_take, uniform,
                      torch.where(is_neg, 1e6 + uniform, inf))
    sel = _take(pos_take | is_neg, pri, num)
    return pos_take, sel


def _check_rpn_bbox_loss(cfg):
    """The RPN's ``loss_bbox`` -> fn(pred, target, weight, avg_factor): L1
    (the default and the Faster R-CNN config's) or SmoothL1(beta) (the
    cascade configs'); another type raises."""
    cfg = dict(cfg or {})
    t = cfg.get("type", "L1Loss")
    lw = float(cfg.get("loss_weight", 1.0))
    if t == "L1Loss":
        return lambda p, tg, w, af: lw * L.l1_loss(p, tg, weight=w,
                                                  avg_factor=af)
    if t == "SmoothL1Loss":
        beta = float(cfg.get("beta", 1.0))
        return lambda p, tg, w, af: lw * L.smooth_l1_loss(
            p, tg, beta=beta, weight=w, avg_factor=af)
    raise NotImplementedError(f"RPN loss_bbox {t} is not ported yet")


def _featmap_sizes(per_level) -> list[tuple[int, int]]:
    return [tuple(x.shape[1:3]) for x in per_level]


def rpn_loss(head: RPNHead, scores, deltas, batch: dict, uniform: torch.Tensor,
             train_cfg: dict | None = None) -> dict:
    """RPN training loss with the reference ``train_cfg.rpn`` semantics:
    MaxIoU assignment (``min_pos_iou`` 0.3, low-quality match), the random
    subsample, and BCE and the box loss both averaged by the sampled
    count. ``uniform`` (B, A): the subsample's draws. With an
    ``allowed_border`` >= 0 and ``img_shapes`` in the batch, the anchors
    outside their image by more than it take no part (as the JAX loss)."""
    tc = dict(train_cfg or {})
    border = float(tc.get("allowed_border", -1))
    asn = dict(tc.get("assigner", {}) or {})
    smp = dict(tc.get("sampler", {}) or {})
    anchors = head.anchors.flat_anchors(_featmap_sizes(scores),
                                        scores[0].device)
    inside = None
    if border >= 0 and batch.get("img_shapes") is not None:
        inside = anchor_inside_flags(anchors, batch["img_shapes"], border)
    labels, assigned, weights, _ = max_iou_assign(
        anchors, batch["gt_bboxes"], torch.zeros_like(batch["gt_labels"]),
        batch["gt_valid"],
        pos_iou_thr=float(asn.get("pos_iou_thr", head.pos_iou_thr)),
        neg_iou_thr=float(asn.get("neg_iou_thr", head.neg_iou_thr)),
        min_pos_iou=float(asn.get("min_pos_iou", 0.3)),
        match_low_quality=bool(asn.get("match_low_quality", True)),
        num_classes=1, inside=inside)
    b = labels.shape[0]
    flat_score = torch.cat([s.reshape(b, -1) for s in scores], dim=1)
    flat_delta = torch.cat([d.reshape(b, -1, 4) for d in deltas], dim=1)
    is_pos = labels < 1
    is_neg = (weights > 0) & ~is_pos
    pos_take, sel = subsample_anchors(
        uniform, is_pos, is_neg, num=int(smp.get("num", 256)),
        pos_fraction=float(smp.get("pos_fraction", 0.5)))
    pos_f = pos_take.to(torch.float32)
    sel_f = sel.to(torch.float32)
    num_total = torch.clamp_min(sel_f.sum(), 1.0)
    loss_cls = float(dict(head.loss_cls or {}).get("loss_weight", 1.0)) \
        * L.binary_cross_entropy(flat_score, pos_f, weight=sel_f,
                                 avg_factor=num_total)
    gt = _gather_rows(batch["gt_bboxes"], assigned.clamp_min(0))
    enc, _, means, stds = resolve_delta_coder(
        head.bbox_coder, head.target_means, head.target_stds)
    tgt = enc(anchors[None], gt, means, stds)
    loss_reg = _check_rpn_bbox_loss(head.loss_bbox)(
        flat_delta, tgt, pos_f[..., None], num_total)
    return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_reg)


@torch.no_grad()
def rpn_proposals(head: RPNHead, scores, deltas, img_shapes=None,
                  nms_pre: int = 1000, nms_iou: float = 0.7,
                  num_proposals: int = 1000, min_bbox_size: float = 0.0):
    """Fixed-shape proposals: per level sigmoid and the ``nms_pre`` best
    (ties to the lower index), decode and clip to ``img_shapes`` (B, 2)
    where given, the ``min_bbox_size`` filter, then one NMS per image over
    all levels with each level's boxes shifted by ``level * (max + 1)`` so
    that levels never suppress each other (one kernel launch for the
    batch, at N = the candidates of all levels).

    Returns proposals (B, num_proposals, 4), scores (B, num_proposals) and
    valid (B, num_proposals); padded rows have zero boxes."""
    lvl_anchors = head.anchors.grid_anchors(_featmap_sizes(scores),
                                            scores[0].device)
    b = scores[0].shape[0]
    _, dec, means, stds = resolve_delta_coder(
        head.bbox_coder, head.target_means, head.target_stds)
    box_list, score_list, lvl_list = [], [], []
    for lvl, (sc, dl) in enumerate(zip(scores, deltas)):
        sc = torch.sigmoid(sc.reshape(b, -1))
        dl = dl.reshape(b, -1, 4)
        k = min(nms_pre, sc.shape[1])
        top_sc, top_idx = torch.sort(sc, dim=1, descending=True, stable=True)
        top_sc, top_idx = top_sc[:, :k], top_idx[:, :k]
        boxes = dec(lvl_anchors[lvl][top_idx], _gather_rows(dl, top_idx),
                    means, stds)
        if img_shapes is not None:
            boxes = clip_to_shapes(boxes, img_shapes)
        box_list.append(boxes)
        score_list.append(top_sc)
        lvl_list.append(torch.full((k,), float(lvl), device=sc.device))
    boxes = torch.cat(box_list, dim=1)
    sc = torch.cat(score_list, dim=1)
    lvl_ids = torch.cat(lvl_list)
    size_ok = ((boxes[..., 2] - boxes[..., 0] > min_bbox_size)
               & (boxes[..., 3] - boxes[..., 1] > min_bbox_size))
    zero = boxes.new_zeros(())
    max_coord = torch.where(size_ok[..., None], boxes, zero).amax(dim=(1, 2)) + 1.0
    shifted = boxes + (lvl_ids[None] * max_coord[:, None])[..., None]
    dets, idx, valid = nms(shifted, sc, nms_iou, max_out=num_proposals,
                           valid=size_ok)
    out_boxes = torch.where(valid[..., None], _gather_rows(boxes, idx), zero)
    return out_boxes, dets[..., 4], valid
