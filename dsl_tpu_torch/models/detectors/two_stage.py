"""Two-stage detectors (Faster, Mask and Mask Scoring R-CNN, FPN and C4) and
the halves (RPN, Fast R-CNN).

Counterpart of the Faster and Mask R-CNN branches of
``dsl_tpu/models/detectors/two_stage.py``: ``TwoStageDetector`` /
``FasterRCNN`` (backbone -> FPN P2-P6 -> RPN; the RoI head's bbox head on
RoIAlign features of P2-P5; or one level through ``IdentityNeck``, the
DC5 configs), ``MaskRCNN`` (an ``FCNMaskHead`` at ``roi_head.mask_head``
on 14x14 RoIAlign features of the same levels), ``FasterRCNNC4`` and
``MaskRCNNC4`` (one C4 level at stride 16, 14x14 RoIs through the res5
``ResLayerSharedHead`` at ``roi_head.shared_head`` before the bbox head
and before the mask head), ``MaskScoringRCNN`` (Mask R-CNN with a
``MaskIoUHead`` at ``roi_head.mask_iou_head``), ``PointRend`` (Mask
R-CNN whose mask head is a ``CoarseMaskHead`` of 7x7 logits, with a
``MaskPointHead`` at ``roi_head.point_head``), ``DetectoRS`` (Faster
R-CNN whose neck, RFP, reads the image beside the backbone's levels),
``build_two_stage_detector``,
``parse_rcnn_train_cfg``, ``two_stage_loss`` (the box head's RoI features
pooled deformably where the detector has a ``roi_pool_pack``, the dpool
and mdpool configs', at ``roi_head.roi_pool_pack``; the mask branch pools
plainly, as in the JAX package; with the mask branch on the
positives of the same samples where the batch has ``gt_mask_crops``: a
mask config whose pipeline loads no masks trains without ``loss_mask``,
as in the JAX package; Mask Scoring R-CNN's ``loss_mask_iou`` on the same
positives, its IoU head fed the mask head's probabilities without a
stop, so that loss also trains the mask head, as in the JAX package;
PointRend's ``loss_point`` on the same positives' importance-sampled
points),
``two_stage_predict``, ``mask_logits_for_boxes`` and ``mask_rcnn_predict``
(the boxes and each detection's 28x28 probabilities of its class; Mask
Scoring R-CNN's too, whose IoU head rescales no score at test time, as in
the JAX package; PointRend's from its 7x7 coarse logits through
``subdivision_steps`` of the point head, ``point_rend_refine``); the
standalone ``RPN`` (``rpn_only_loss``, ``rpn_only_predict``: the
proposals are the detections) and ``FastRCNN`` (``fast_rcnn_predict`` on proposals passed
in; the JAX package has no Fast R-CNN loss, and neither has the port).
The bbox head sits at ``roi_head.bbox_head``, mmdet's name, so an mmdet
checkpoint loads by its own keys; the weight bridge maps the JAX
package's top-level ``bbox_head`` there.

As in the JAX package, training proposals are ``rpn_proposals`` with
``nms_pre = num_proposals = 512`` and predict's 1000, and the loss and the
predict run in f32 whatever the compute dtype: here a bf16 compute dtype
raises rather than run f32 unasked. The samplers' random draws (the RPN's
256 anchors, the RoI head's 512 RoIs per image, each Cascade R-CNN
stage's in turn, then PointRend's point draws) come from one
``torch.Generator`` seeded by the iteration (:func:`sampler_draws`); the
JAX package draws threefry uniforms from ``fold_in(PRNGKey(0), iter)``,
so the two sample other anchors and RoIs from one seed (the samplers
themselves are equal given the same draws). The two-stage loss takes no
process group (the JAX one takes no axis) and raises under one.

Detectors built on this one that are not ported yet raise
``NotImplementedError`` naming themselves.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from dsl_tpu_torch.registry import DETECTORS, MODELS, build_from_cfg
from dsl_tpu_torch.models.dense_heads.rpn_head import (
    RPNHead, rpn_loss, rpn_proposals)
from dsl_tpu_torch.models.necks.channel_mapper import build_neck
from dsl_tpu_torch.models.roi_heads.mask_head import (
    mask_head_loss, mask_targets_from_crops, select_positive_rois)
from dsl_tpu_torch.models.roi_heads.maskiou_head import (
    mask_iou_loss, mask_iou_target)
from dsl_tpu_torch.models.roi_heads.point_rend import (
    IMPORTANCE_RATIO, OVERSAMPLE_RATIO, TRAIN_POINTS, point_branch_loss,
    point_rend_refine, uncertain_points_train)
from dsl_tpu_torch.models.roi_heads.standard_roi_head import (
    Shared2FCBBoxHead, extract_roi_feats, flat_rois, roi_head_loss,
    roi_head_predict, sample_batch_rois)

# the JAX package's two-stage detectors and parts not ported yet
UNPORTED_DETECTORS = (
    "DynamicRCNN", "PISAFasterRCNN", "PISAMaskRCNN", "DoubleHeadRCNN",
    "GridRCNN", "TridentFasterRCNN", "SparseRCNN")
UNPORTED_PARTS = ("grid_head",)
TRAIN_PROPOSALS = 512          # two_stage_loss's num_proposals in JAX
TEST_PROPOSALS = 1000          # two_stage_predict's
SAMPLER_SEED = 97              # the draws' generator: this * 2**32 + iteration
BBOX_HEADS = ("Shared2FCBBoxHead", "Shared4Conv1FCBBoxHead", "BBoxHeadAvgPool")
FAST_RCNN_STRIDES = (4, 8, 16, 32)   # fast_rcnn_predict's RoI levels in JAX


class StandardRoIHead(nn.Module):
    """Holds the bbox head, and the mask head, the shared head, the mask
    IoU head, the point head and the deformable RoI pooling's pack where
    there are, under mmdet's names (``roi_head.bbox_head``,
    ``roi_head.mask_head``, ``roi_head.shared_head``,
    ``roi_head.mask_iou_head``, ``roi_head.point_head``) and the JAX
    package's (``roi_head.roi_pool_pack``: mmdet keeps one pack per level
    in ``roi_head.bbox_roi_extractor.roi_layers.{i}``, the JAX package one
    for all; an mmdet checkpoint loads where its levels' packs are equal,
    and raises naming the keys where they differ)."""

    def __init__(self, bbox_head: nn.Module, mask_head: nn.Module | None = None,
                 shared_head: nn.Module | None = None,
                 mask_iou_head: nn.Module | None = None,
                 point_head: nn.Module | None = None,
                 roi_pool_pack: nn.Module | None = None):
        super().__init__()
        self.bbox_head = bbox_head
        self.mask_head = mask_head
        self.shared_head = shared_head
        self.mask_iou_head = mask_iou_head
        self.point_head = point_head
        self.roi_pool_pack = roi_pool_pack

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        layers = prefix + "bbox_roi_extractor.roi_layers."
        per_level: dict = {}
        for key in [k for k in state_dict if k.startswith(layers)]:
            level, name = key[len(layers):].split(".", 1)
            per_level.setdefault(name, {})[level] = state_dict.pop(key)
        for name, levels in per_level.items():
            first = levels[min(levels)]
            if self.roi_pool_pack is None or not all(
                    torch.equal(v, first) for v in levels.values()):
                raise KeyError(
                    f"{[layers + lv + '.' + name for lv in sorted(levels)]}: "
                    f"per-level deformable RoI pooling packs that differ (or "
                    f"a detector without one); the JAX package's and the "
                    f"port's pack is one for all levels")
            state_dict[f"{prefix}roi_pool_pack.{name}"] = first
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


@DETECTORS.register
class TwoStageDetector(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: RPNHead, bbox_head: Shared2FCBBoxHead,
                 train_cfg: Any = None, test_cfg: Any = None,
                 mask_head: nn.Module | None = None,
                 shared_head: nn.Module | None = None,
                 mask_iou_head: nn.Module | None = None,
                 point_head: nn.Module | None = None,
                 roi_pool_pack: nn.Module | None = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = StandardRoIHead(bbox_head, mask_head, shared_head,
                                        mask_iou_head, point_head,
                                        roi_pool_pack)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def bbox_head(self) -> Shared2FCBBoxHead:
        return self.roi_head.bbox_head

    @property
    def mask_head(self) -> nn.Module | None:
        return self.roi_head.mask_head

    @property
    def shared_head(self) -> nn.Module | None:
        return self.roi_head.shared_head

    @property
    def mask_iou_head(self) -> nn.Module | None:
        return self.roi_head.mask_iou_head

    @property
    def point_head(self) -> nn.Module | None:
        return self.roi_head.point_head

    @property
    def roi_pool_pack(self) -> nn.Module | None:
        return self.roi_head.roi_pool_pack

    @property
    def strides(self) -> tuple:
        """The RoI levels' strides (the RPN's first four)."""
        return tuple(self.rpn_head.strides)[:4]

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, self.neck, self.rpn_head, self.bbox_head,
                     self.mask_head, self.shared_head, self.mask_iou_head,
                     self.point_head, self.roi_pool_pack):
            if part is not None:
                part.init_weights(generator)

    def extract_feat(self, images: torch.Tensor):
        return self.neck(self.backbone(images))

    def _shared(self, roi_feats: torch.Tensor) -> torch.Tensor:
        return (roi_feats if self.shared_head is None
                else self.shared_head(roi_feats))

    def forward(self, inputs: torch.Tensor, training: bool = False,
                stage: str = "rpn", mask_pred: torch.Tensor | None = None,
                coarse: torch.Tensor | None = None):
        """``stage="rpn"``: images NCHW -> (FPN levels, (RPN scores, RPN
        deltas)); ``stage="roi"``: RoI features (N, C, s, s) -> the bbox
        head's (cls_logits, deltas); ``stage="mask"``: RoI features -> the
        mask head's logits (N, classes, S, S); ``stage="mask_iou"``: mask
        RoI features and ``mask_pred`` (N, S, S) -> the mask IoU head's
        (N, classes); ``stage="point"``: fine point features (..., P, C)
        and the ``coarse`` logits at the points (..., P, classes) -> the
        point head's (..., P, classes); ``stage="pack"``: plain RoI
        features -> the deformable RoI pooling pack's (offsets, mask). The
        shared head, where there is one, runs before the bbox and the mask
        head. One forward for all, so that ``functional_call`` can run each
        with other parameters."""
        if stage == "pack":
            return self.roi_pool_pack(inputs)
        if stage == "roi":
            return self.bbox_head(self._shared(inputs))
        if stage == "mask":
            return self.mask_head(self._shared(inputs))
        if stage == "mask_iou":
            return self.mask_iou_head(inputs, mask_pred)
        if stage == "point":
            return self.point_head(inputs, coarse)
        feats = self.extract_feat(inputs)
        return feats, self.rpn_head(feats, training=training)


@DETECTORS.register
class FasterRCNN(TwoStageDetector):
    """Faster R-CNN (``mmdet/models/detectors/faster_rcnn.py``)."""


@DETECTORS.register
class MaskRCNN(TwoStageDetector):
    """Mask R-CNN (``mmdet/models/detectors/mask_rcnn.py``): Faster R-CNN
    and an FCN mask head on the RoI features."""


@DETECTORS.register
class FasterRCNNC4(TwoStageDetector):
    """Faster R-CNN C4: one C4 level (stride 16), 14x14 RoIAlign, the res5
    shared head per RoI, the average-pool bbox head."""


@DETECTORS.register
class MaskRCNNC4(FasterRCNNC4):
    """Mask R-CNN C4: the mask head reads the shared head's features of the
    positive RoIs (and of the detections)."""


@DETECTORS.register
class MaskScoringRCNN(MaskRCNN):
    """Mask Scoring R-CNN (``mmdet/models/detectors/mask_scoring_rcnn.py``):
    Mask R-CNN and a MaskIoU head, trained on the mask head's positives.
    As in the JAX package, its predict is Mask R-CNN's."""


@DETECTORS.register
class DetectoRS(TwoStageDetector):
    """DetectoRS on Faster R-CNN (``configs/detectors``): the SAC backbone
    and the RFP neck, which reruns its own backbone on the image, so it
    reads ``(image, C2..C5)``. DetectoRS on a cascade is built by
    ``cascade_rcnn.build_cascade_rcnn``."""

    def extract_feat(self, images: torch.Tensor):
        return self.neck((images, *self.backbone(images)))


@DETECTORS.register
class PointRend(MaskRCNN):
    """PointRend (``mmdet/models/detectors/point_rend.py``): Mask R-CNN
    whose mask head gives coarse 7x7 logits, refined at test time by the
    point head on the most uncertain points of a finer grid, and trained
    with ``loss_point`` on importance-sampled points."""


MASK_DETECTORS = ("MaskRCNN", "MaskRCNNC4", "MaskScoringRCNN", "PointRend")
C4_DETECTORS = ("FasterRCNNC4", "MaskRCNNC4")


@DETECTORS.register
class RPN(nn.Module):
    """The standalone RPN (``mmdet/models/detectors/rpn.py``): backbone ->
    neck -> RPN head, whose proposals are the detections."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: RPNHead, train_cfg: Any = None,
                 test_cfg: Any = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, self.neck, self.rpn_head):
            part.init_weights(generator)

    def forward(self, images: torch.Tensor, training: bool = False):
        """images NCHW -> (levels, (RPN scores, RPN deltas))."""
        feats = self.neck(self.backbone(images))
        return feats, self.rpn_head(feats, training=training)


@DETECTORS.register
class FastRCNN(nn.Module):
    """Fast R-CNN (``mmdet/models/detectors/fast_rcnn.py``): the RoI head
    alone, on proposals from outside; the bbox head at mmdet's
    ``roi_head.bbox_head``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, train_cfg: Any = None,
                 test_cfg: Any = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.roi_head = StandardRoIHead(bbox_head)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def bbox_head(self) -> nn.Module:
        return self.roi_head.bbox_head

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, self.neck, self.bbox_head):
            part.init_weights(generator)

    def forward(self, inputs: torch.Tensor, training: bool = False,
                stage: str = "feats"):
        """``stage="feats"``: images -> the neck's levels; ``"roi"``: RoI
        features -> the bbox head's (cls_logits, deltas)."""
        if stage == "roi":
            return self.bbox_head(inputs)
        return self.neck(self.backbone(inputs))


def _check_head(cfg: dict, key: str, allowed):
    got = dict(cfg[key]).get("type")
    if got not in allowed:
        raise NotImplementedError(f"{key} {got} is not ported yet: only "
                                  f"{', '.join(allowed)}")


def build_two_stage_detector(cfg: dict) -> nn.Module:
    cfg = dict(cfg)
    det_type = cfg.pop("type", "FasterRCNN")
    if det_type in UNPORTED_DETECTORS:
        raise NotImplementedError(f"{det_type} is not ported yet")
    for key in UNPORTED_PARTS:
        if cfg.get(key) is not None:
            raise NotImplementedError(f"a two-stage detector with {key!r} is "
                                      f"not ported yet")
    neck_cfg = cfg.pop("neck")
    if det_type != "FastRCNN":
        _check_head(cfg, "rpn_head", ("RPNHead",))
    if det_type != "RPN":
        _check_head(cfg, "bbox_head", BBOX_HEADS)
    for key, allowed in (("mask_head", ("FCNMaskHead", "CoarseMaskHead")),
                         ("shared_head", ("ResLayerSharedHead",)),
                         ("mask_iou_head", ("MaskIoUHead",)),
                         ("point_head", ("MaskPointHead",))):
        if cfg.get(key) is not None:
            _check_head(cfg, key, allowed)
    det_cls = MODELS.get(det_type)
    if det_cls is None:
        raise KeyError(f"unknown detector type {det_type}")
    if not issubclass(det_cls, (TwoStageDetector, RPN, FastRCNN)):
        raise TypeError(f"{det_type} is a cascade: its config has bbox_heads "
                        f"(one per stage), not one bbox_head")
    backbone = build_from_cfg(dict(cfg.pop("backbone")), MODELS)
    parts = dict(backbone=backbone, neck=build_neck(neck_cfg, backbone),
                 train_cfg=cfg.pop("train_cfg", None),
                 test_cfg=cfg.pop("test_cfg", None))
    if det_type != "FastRCNN":
        parts["rpn_head"] = build_from_cfg(dict(cfg.pop("rpn_head")), MODELS)
    for key, types in (("mask_head", MASK_DETECTORS),
                       ("shared_head", C4_DETECTORS),
                       ("mask_iou_head", ("MaskScoringRCNN",)),
                       ("point_head", ("PointRend",))):
        if (cfg.get(key) is not None) != (det_type in types):
            raise TypeError(f"{det_type} with {key}={cfg.get(key)!r}: the "
                            f"{key} is {' and '.join(types)}'s")
    if cfg.get("shared_head") is not None:
        parts["shared_head"] = build_from_cfg(
            dict(cfg.pop("shared_head"),
                 in_channels=dict(cfg["bbox_head"])["in_channels"]), MODELS)
    if det_type != "RPN":
        bbox_cfg = dict(cfg.pop("bbox_head"))
        if "shared_head" in parts:
            bbox_cfg["fc_in_channels"] = parts["shared_head"].out_channels
        parts["bbox_head"] = build_from_cfg(bbox_cfg, MODELS)
    for key in ("mask_head", "mask_iou_head", "point_head"):
        if cfg.get(key) is not None:
            parts[key] = build_from_cfg(dict(cfg.pop(key)), MODELS)
    if cfg.get("roi_pool_pack") is not None:
        if not issubclass(det_cls, TwoStageDetector):
            raise TypeError(f"{det_type} with a roi_pool_pack: the pack is a "
                            f"two-stage RoI head's")
        _check_head(cfg, "roi_pool_pack", ("DeformRoIPoolPack",
                                           "ModulatedDeformRoIPoolPack"))
        parts["roi_pool_pack"] = build_from_cfg(dict(cfg.pop("roi_pool_pack")),
                                                MODELS)
    return det_cls(**parts)


def parse_rcnn_train_cfg(train_cfg, stage_cfg=None) -> dict:
    """A reference-style ``train_cfg.rcnn`` (assigner and sampler blocks),
    or ``stage_cfg``, one Cascade R-CNN stage's entry of a list
    ``train_cfg.rcnn``, as ``sample_rois`` keywords, with the reference
    Faster R-CNN defaults. A sampler other than the random one raises."""
    rc = dict(stage_cfg if stage_cfg is not None
              else dict(train_cfg or {}).get("rcnn", {}) or {})
    asn = dict(rc.get("assigner", {}) or {})
    smp = dict(rc.get("sampler", {}) or {})
    kind = smp.get("type", "RandomSampler")
    if kind != "RandomSampler":
        raise NotImplementedError(f"rcnn sampler {kind} is not ported yet")
    return dict(
        num_samples=int(smp.get("num", 512)),
        pos_fraction=float(smp.get("pos_fraction", 0.25)),
        add_gt_as_proposals=bool(smp.get("add_gt_as_proposals", True)),
        pos_iou_thr=float(asn.get("pos_iou_thr", 0.5)),
        neg_iou_thr=float(asn.get("neg_iou_thr", 0.5)),
        min_pos_iou=float(asn.get("min_pos_iou", 0.5)),
        match_low_quality=bool(asn.get("match_low_quality", False)))


def sampler_draws(cur_iter: int, batch_size: int, num_anchors: int,
                  num_candidates: int, device, stages: int = 1,
                  points: tuple | None = None) -> dict:
    """The samplers' uniforms for one step: ``rpn`` (B, anchors) then
    ``rcnn``, a tuple of ``stages`` (B, proposals + GT slots) tensors (one
    per Cascade R-CNN stage, one otherwise) drawn in stage order, then,
    where ``points`` = (RoIs, oversampled, fill) is given (PointRend),
    ``point``: the (RoIs, oversampled, 2) and (RoIs, fill, 2) uniform
    points of :func:`point_rend.uncertain_points_train`; all from a
    generator on ``device`` seeded by the iteration, so a step's samples
    repeat run to run."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SAMPLER_SEED * 2 ** 32 + int(cur_iter))
    rpn = torch.rand((batch_size, num_anchors), generator=gen, device=device)
    rcnn = tuple(torch.rand((batch_size, num_candidates), generator=gen,
                            device=device) for _ in range(stages))
    out = dict(rpn=rpn, rcnn=rcnn)
    if points is not None:
        rois, over, fill = points
        out["point"] = tuple(torch.rand((rois, k, 2), generator=gen,
                                        device=device) for k in (over, fill))
    return out


def point_draw_shape(detector, batch_size: int, num_samples: int):
    """PointRend's ``points`` argument of :func:`sampler_draws` (the mask
    branch's B * num_samples // 4 RoIs, the oversampled and the fill points
    of ``TRAIN_POINTS``), None for another detector."""
    if getattr(detector, "point_head", None) is None:
        return None
    n_imp = int(IMPORTANCE_RATIO * TRAIN_POINTS)
    return (batch_size * max(1, num_samples // 4),
            int(TRAIN_POINTS * OVERSAMPLE_RATIO), TRAIN_POINTS - n_imp)


def check_two_stage(compute_dtype=None, group=None):
    """Refuse what the ported two-stage path does not run."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype} with a two-stage detector: the "
            f"JAX package runs its two-stage loss and predict in f32 "
            f"whatever the dtype; the port refuses rather than do so unasked")
    if group is not None:
        raise NotImplementedError(
            "a process group with a two-stage detector: data-parallel "
            "two-stage training is not ported yet")


def two_stage_loss(detector: TwoStageDetector, batch: dict, cur_iter: int = 0,
                   mark=None):
    """The Faster R-CNN training loss (RPN + RoI head), the losses and the
    log vars as ``single_stage._parse_losses`` gives them; the samplers
    draw :func:`sampler_draws` of ``cur_iter``. ``mark("forward")``, where
    given, is called once the forward is enqueued."""
    from dsl_tpu_torch.models.detectors.single_stage import _parse_losses

    tc = dict(detector.train_cfg or {})
    rcnn_kw = parse_rcnn_train_cfg(tc)
    feats, (scores, deltas) = detector(batch["images"], training=True)
    if mark is not None:
        mark("forward")
    num_anchors = sum(s[0].numel() for s in scores)
    b = scores[0].shape[0]
    points = point_draw_shape(detector, b, rcnn_kw["num_samples"])
    draws = sampler_draws(cur_iter, b, num_anchors,
                          TRAIN_PROPOSALS + batch["gt_bboxes"].shape[1],
                          scores[0].device,
                          **({} if points is None else dict(points=points)))
    losses = rpn_loss(detector.rpn_head, scores, deltas, batch, draws["rpn"],
                      train_cfg=dict(tc.get("rpn", {}) or {}))
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=batch.get("img_shapes"),
        nms_pre=TRAIN_PROPOSALS, num_proposals=TRAIN_PROPOSALS)
    head = detector.bbox_head
    samples = sample_batch_rois(proposals, prop_valid, batch, draws["rcnn"][0],
                                head.num_classes, **rcnn_kw)
    losses.update(roi_head_loss(head, lambda rf: detector(rf, stage="roi"),
                                feats, samples, batch, detector.strides,
                                _pack(detector, detector)))
    if detector.mask_head is not None and "gt_mask_crops" in batch:
        losses.update(mask_branch_losses(detector, feats, samples, batch,
                                         rcnn_kw["num_samples"],
                                         draws.get("point")))
    return _parse_losses(losses)


def mask_branch_losses(detector: nn.Module, feats, samples: dict, batch: dict,
                       num_samples: int, point_draws=None) -> dict:
    """``loss_mask`` on the positives of the RoI head's samples: the first
    ``num_samples // 4`` RoIs of each image with the positives first, their
    14x14 features (through the shared head where there is one), the mask
    head, the targets from ``batch["gt_mask_crops"]`` at the logits' size,
    and the per-class BCE over the positives. With a mask IoU head (Mask
    Scoring R-CNN), also ``loss_mask_iou``: the head on the same features
    and the assigned class's probabilities (not detached), against the IoU
    with each instance's whole mask (``gt_mask_areas``). With a point head
    (PointRend), also ``loss_point`` on the points
    ``uncertain_points_train`` picks from ``point_draws`` (oversampled,
    fill)."""
    mh = detector.mask_head
    b = samples["rois"].shape[0]
    max_pos = max(1, num_samples // 4)
    rois, labels, assigned, is_pos = select_positive_rois(
        samples["rois"], samples["labels"], samples["assigned"],
        samples["is_pos"], max_pos)
    pos = is_pos.reshape(-1)
    roi_feats = extract_roi_feats(feats, flat_rois(rois), pos,
                                  detector.strides, mh.roi_size)
    logits = detector(roi_feats, stage="mask")
    batch_idx = torch.arange(b, device=rois.device)[:, None].expand(b, max_pos)
    targets = mask_targets_from_crops(
        batch["gt_mask_crops"], batch["gt_bboxes"], rois.reshape(-1, 4),
        batch_idx.reshape(-1), assigned.reshape(-1),
        mask_size=logits.shape[-1])
    pos_f = pos.to(torch.float32)
    out = dict(loss_mask=mask_head_loss(logits, targets, labels.reshape(-1),
                                        pos_f, mh.num_classes))
    if getattr(detector, "point_head", None) is not None:
        rel = uncertain_points_train(*point_draws, logits, labels.reshape(-1))
        out["loss_point"] = point_branch_loss(
            lambda fine, cpts: detector(fine, stage="point", coarse=cpts),
            feats[0], logits, rel, rois, labels, assigned, is_pos, batch,
            stride=detector.strides[0])
    iou_head = getattr(detector, "mask_iou_head", None)
    if iou_head is None:
        return out
    probs = class_probs(logits, labels, mh.num_classes)
    k = batch["gt_bboxes"].shape[1]
    bidx = batch_idx.reshape(-1)
    crop_idx = bidx * k + assigned.reshape(-1).clamp(0, k - 1)
    crops = batch["gt_mask_crops"]
    iou_t = mask_iou_target(
        probs, targets, pos_f,
        gt_full_areas=batch["gt_mask_areas"].reshape(-1)[crop_idx],
        crops=crops.reshape(-1, *crops.shape[2:])[crop_idx],
        gt_boxes=batch["gt_bboxes"].reshape(-1, 4)[crop_idx],
        rois=rois.reshape(-1, 4), img_shapes=batch["img_shapes"][bidx])
    iou_pred = detector(roi_feats, stage="mask_iou", mask_pred=probs)
    out["loss_mask_iou"] = mask_iou_loss(iou_pred, labels.reshape(-1), iou_t,
                                         pos_f, iou_head.num_classes)
    return out


@torch.no_grad()
def two_stage_predict(detector: TwoStageDetector, images: torch.Tensor,
                      img_shapes=None, scale_factors=None,
                      test_cfg: dict | None = None,
                      variables: dict | None = None):
    """RPN proposals (1000 per image), the RoI head on them, per-class
    decode and NMS: dets (B, max_per_img, 5), labels, valid. ``variables``
    (name -> tensor: parameters and buffers) replace the detector's own
    where given. Two launches of the NMS kernel: the RPN's and the RoI
    head's."""
    return _boxes(detector, _caller(detector, variables), images, img_shapes,
                  scale_factors, test_cfg)[1:]


def _pack(detector: TwoStageDetector, call):
    """``extract_roi_feats``' ``pack`` of the detector (through ``call``,
    its forward or a functional call of it), None without a
    ``roi_pool_pack``."""
    pk = detector.roi_pool_pack
    return None if pk is None else (lambda rf: call(rf, stage="pack"), pk)


def _caller(detector: TwoStageDetector, variables: dict | None):
    """The detector's forward, or a functional call of it with
    ``variables`` (name -> tensor) in place of its own."""
    def call(*args, **kw):
        if variables is None:
            return detector(*args, **kw)
        return functional_call(detector, variables, args, kw)
    return call


def _boxes(detector, call, images, img_shapes, scale_factors, test_cfg):
    """The features, then the RPN's proposals and the RoI head's dets,
    labels and valid: two launches of the NMS kernel."""
    tc = dict(test_cfg or detector.test_cfg or {})
    rcnn = dict(tc.get("rcnn", {}) or {})
    nms_cfg = dict(rcnn.get("nms", {}) or {})
    feats, (scores, deltas) = call(images)
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=img_shapes,
        nms_pre=TEST_PROPOSALS, num_proposals=TEST_PROPOSALS)
    return (feats, *roi_head_predict(
        detector.bbox_head, lambda rf: call(rf, stage="roi"), feats,
        proposals, prop_valid, img_shapes=img_shapes,
        scale_factors=scale_factors, strides=detector.strides,
        score_thr=rcnn.get("score_thr", 0.05),
        iou_threshold=nms_cfg.get("iou_threshold", 0.5),
        max_per_img=rcnn.get("max_per_img", 100), nms_cfg=nms_cfg,
        pack=_pack(detector, call)))


def mask_logits_for_boxes(detector: TwoStageDetector, feats, boxes_in,
                          valid, call=None) -> torch.Tensor:
    """The mask head's logits (B*N, classes, S, S) at boxes (B, N, 4) in
    the input image's frame, valid (B, N): the mask half of mmdet's
    ``simple_test_mask``, and what mask TTA runs per augmentation at the
    merged boxes. ``call`` is the detector's forward (or a functional call
    of it)."""
    call = call or detector
    roi_feats = extract_roi_feats(feats, flat_rois(boxes_in), valid.reshape(-1),
                                  detector.strides, detector.mask_head.roi_size)
    return call(roi_feats, stage="mask")


def class_probs(logits: torch.Tensor, labels: torch.Tensor,
                num_classes: int) -> torch.Tensor:
    """The sigmoid of each RoI's logits (N, C, S, S) at its label (N,)."""
    s = logits.shape[-1]
    cls = labels.reshape(-1).clamp(0, num_classes - 1)
    return torch.sigmoid(torch.gather(
        logits, 1, cls[:, None, None, None].expand(-1, 1, s, s))[:, 0])


@torch.no_grad()
def mask_rcnn_predict(detector: TwoStageDetector, images: torch.Tensor,
                      img_shapes=None, scale_factors=None,
                      test_cfg: dict | None = None,
                      variables: dict | None = None):
    """:func:`two_stage_predict`'s boxes, then the mask head at the
    detections (scaled back to the input's frame): dets (B, N, 5) in the
    original frame, labels, valid and each detection's probabilities of
    its class, (B, N, S, S). With a point head (PointRend) the coarse
    logits go through ``test_cfg``'s ``subdivision_steps`` (2) of
    ``subdivision_num_points`` (196), P2 the fine level. The host pastes
    them at the boxes (``mask_head.paste_masks``). Two launches of the NMS
    kernel."""
    from dsl_tpu_torch.models.detectors.single_stage import (
        check_predict_device)

    check_predict_device(detector, images, images.device)
    call = _caller(detector, variables)
    feats, dets, labels, valid = _boxes(detector, call, images, img_shapes,
                                        scale_factors, test_cfg)
    b, n = dets.shape[:2]
    boxes_in = dets[..., :4]
    if scale_factors is not None:
        boxes_in = boxes_in * scale_factors[:, None, :]
    logits = mask_logits_for_boxes(detector, feats, boxes_in, valid, call)
    if detector.point_head is not None:
        tc = dict(test_cfg or detector.test_cfg or {})
        logits = point_rend_refine(
            logits.reshape(b, n, *logits.shape[1:]), feats[0], boxes_in,
            labels, lambda fine, cpts: call(fine, stage="point", coarse=cpts),
            subdivision_steps=int(tc.get("subdivision_steps", 2)),
            num_points=int(tc.get("subdivision_num_points", 196)),
            stride=detector.strides[0]).flatten(0, 1)
    probs = class_probs(logits, labels, detector.mask_head.num_classes)
    s = probs.shape[-1]
    return dets, labels, valid, probs.reshape(b, n, s, s)


def rpn_only_loss(detector: RPN, batch: dict, cur_iter: int = 0, mark=None):
    """The standalone RPN's loss (``train_cfg.rpn``, its ``allowed_border``
    included), the subsample drawing :func:`sampler_draws`' ``rpn`` draws of
    ``cur_iter``. Returns (total, log_vars)."""
    from dsl_tpu_torch.models.detectors.single_stage import _parse_losses

    _, (scores, deltas) = detector(batch["images"], training=True)
    if mark is not None:
        mark("forward")
    num_anchors = sum(s[0].numel() for s in scores)
    draws = sampler_draws(cur_iter, scores[0].shape[0], num_anchors, 0,
                          scores[0].device)
    tc = dict(dict(detector.train_cfg or {}).get("rpn", {}) or {})
    return _parse_losses(rpn_loss(detector.rpn_head, scores, deltas, batch,
                                  draws["rpn"], train_cfg=tc))


@torch.no_grad()
def rpn_only_predict(detector: RPN, images: torch.Tensor, img_shapes=None,
                     scale_factors=None, num_proposals: int = TEST_PROPOSALS):
    """The proposals as detections: dets (B, num_proposals, 5) [x1, y1,
    x2, y2, objectness], labels (all 0), valid; as the JAX function, the
    ``test_cfg`` is not read (``nms_pre`` 1000, IoU 0.7). One launch of the
    NMS kernel."""
    _, (scores, deltas) = detector(images)
    boxes, sc, valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=img_shapes,
        num_proposals=num_proposals)
    if scale_factors is not None:
        boxes = boxes / scale_factors[:, None, :]
    dets = torch.cat([boxes, sc[..., None]], dim=-1)
    return dets, torch.zeros(sc.shape, dtype=torch.int64,
                             device=sc.device), valid


@torch.no_grad()
def fast_rcnn_predict(detector: FastRCNN, images: torch.Tensor,
                      proposals: torch.Tensor, prop_valid: torch.Tensor,
                      img_shapes=None, scale_factors=None,
                      test_cfg: dict | None = None):
    """The RoI head on proposals passed in (B, P, 4) in the input's frame,
    prop_valid (B, P): dets (B, max_per_img, 5), labels, valid. As the JAX
    function, the RoI levels are P2-P5 and ``test_cfg.rcnn``'s score
    threshold, IoU and ``max_per_img`` are read. One launch of the NMS
    kernel."""
    from dsl_tpu_torch.models.detectors.single_stage import (
        check_predict_device)

    check_predict_device(detector, images, images.device)
    tc = dict(test_cfg or detector.test_cfg or {})
    rcnn = dict(tc.get("rcnn", {}) or {})
    nms_cfg = dict(rcnn.get("nms", {}) or {})
    feats = detector(images)
    return roi_head_predict(
        detector.bbox_head, detector.bbox_head, feats, proposals, prop_valid,
        img_shapes=img_shapes, scale_factors=scale_factors,
        strides=FAST_RCNN_STRIDES, score_thr=rcnn.get("score_thr", 0.05),
        iou_threshold=nms_cfg.get("iou_threshold", 0.5),
        max_per_img=rcnn.get("max_per_img", 100))
