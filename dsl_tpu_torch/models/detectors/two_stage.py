"""Two-stage detectors (Faster R-CNN) and their halves (RPN, Fast R-CNN).

Counterpart of the Faster R-CNN branches of
``dsl_tpu/models/detectors/two_stage.py``: ``TwoStageDetector`` /
``FasterRCNN`` (backbone -> FPN P2-P6 -> RPN; the RoI head's bbox head on
RoIAlign features of P2-P5; or one level through ``IdentityNeck``, the
DC5 configs), ``build_two_stage_detector``, ``parse_rcnn_train_cfg``,
``two_stage_loss`` and ``two_stage_predict``; the standalone ``RPN``
(``rpn_only_loss``, ``rpn_only_predict``: the proposals are the
detections) and ``FastRCNN`` (``fast_rcnn_predict`` on proposals passed
in; the JAX package has no Fast R-CNN loss, and neither has the port).
The bbox head sits at ``roi_head.bbox_head``, mmdet's name, so an mmdet
checkpoint loads by its own keys; the weight bridge maps the JAX
package's top-level ``bbox_head`` there.

As in the JAX package, training proposals are ``rpn_proposals`` with
``nms_pre = num_proposals = 512`` and predict's 1000, and the loss and the
predict run in f32 whatever the compute dtype: here a bf16 compute dtype
raises rather than run f32 unasked. The samplers' random draws (the RPN's
256 anchors, the RoI head's 512 RoIs per image) come from one
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
from dsl_tpu_torch.models.roi_heads.standard_roi_head import (
    Shared2FCBBoxHead, roi_head_loss, roi_head_predict, sample_batch_rois)

# the JAX package's two-stage detectors and parts not ported yet
UNPORTED_DETECTORS = (
    "MaskRCNN", "FasterRCNNC4", "MaskRCNNC4", "DynamicRCNN", "PISAFasterRCNN",
    "PISAMaskRCNN", "DetectoRS", "DoubleHeadRCNN", "PointRend", "GridRCNN",
    "MaskScoringRCNN", "TridentFasterRCNN", "CascadeRCNN", "HTC",
    "HybridTaskCascade", "SCNet", "SparseRCNN")
UNPORTED_PARTS = ("mask_head", "mask_iou_head", "grid_head", "point_head",
                  "shared_head", "roi_pool_pack", "bbox_heads")
TRAIN_PROPOSALS = 512          # two_stage_loss's num_proposals in JAX
TEST_PROPOSALS = 1000          # two_stage_predict's
SAMPLER_SEED = 97              # the draws' generator: this * 2**32 + iteration
BBOX_HEADS = ("Shared2FCBBoxHead", "Shared4Conv1FCBBoxHead")
FAST_RCNN_STRIDES = (4, 8, 16, 32)   # fast_rcnn_predict's RoI levels in JAX


class StandardRoIHead(nn.Module):
    """Holds the bbox head under mmdet's ``roi_head.bbox_head`` name."""

    def __init__(self, bbox_head: nn.Module):
        super().__init__()
        self.bbox_head = bbox_head


@DETECTORS.register
class TwoStageDetector(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: RPNHead, bbox_head: Shared2FCBBoxHead,
                 train_cfg: Any = None, test_cfg: Any = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = StandardRoIHead(bbox_head)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    @property
    def bbox_head(self) -> Shared2FCBBoxHead:
        return self.roi_head.bbox_head

    @property
    def strides(self) -> tuple:
        """The RoI levels' strides (the RPN's first four)."""
        return tuple(self.rpn_head.strides)[:4]

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, self.neck, self.rpn_head, self.bbox_head):
            part.init_weights(generator)

    def extract_feat(self, images: torch.Tensor):
        return self.neck(self.backbone(images))

    def forward(self, inputs: torch.Tensor, training: bool = False,
                stage: str = "rpn"):
        """``stage="rpn"``: images NCHW -> (FPN levels, (RPN scores, RPN
        deltas)); ``stage="roi"``: RoI features (N, C, s, s) -> the bbox
        head's (cls_logits, deltas). One forward for both, so that
        ``functional_call`` can run either with other parameters."""
        if stage == "roi":
            return self.bbox_head(inputs)
        feats = self.extract_feat(inputs)
        return feats, self.rpn_head(feats, training=training)


@DETECTORS.register
class FasterRCNN(TwoStageDetector):
    """Faster R-CNN (``mmdet/models/detectors/faster_rcnn.py``)."""


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
    if isinstance(neck_cfg, (list, tuple)):
        raise NotImplementedError("stacked necks are not ported yet")
    if det_type != "FastRCNN":
        _check_head(cfg, "rpn_head", ("RPNHead",))
    if det_type != "RPN":
        _check_head(cfg, "bbox_head", BBOX_HEADS)
    det_cls = MODELS.get(det_type)
    if det_cls is None:
        raise KeyError(f"unknown detector type {det_type}")
    parts = dict(backbone=build_from_cfg(dict(cfg.pop("backbone")), MODELS),
                 neck=build_from_cfg(dict(neck_cfg), MODELS),
                 train_cfg=cfg.pop("train_cfg", None),
                 test_cfg=cfg.pop("test_cfg", None))
    if det_type != "FastRCNN":
        parts["rpn_head"] = build_from_cfg(dict(cfg.pop("rpn_head")), MODELS)
    if det_type != "RPN":
        parts["bbox_head"] = build_from_cfg(dict(cfg.pop("bbox_head")), MODELS)
    return det_cls(**parts)


def parse_rcnn_train_cfg(train_cfg) -> dict:
    """A reference-style ``train_cfg.rcnn`` (assigner and sampler blocks)
    as ``sample_rois`` keywords, with the reference Faster R-CNN defaults.
    A sampler other than the random one raises."""
    rc = dict(dict(train_cfg or {}).get("rcnn", {}) or {})
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
                  num_candidates: int, device) -> dict:
    """The samplers' uniforms for one step: ``rpn`` (B, anchors) then
    ``rcnn`` (B, proposals + GT slots), from a generator on ``device``
    seeded by the iteration, so a step's samples repeat run to run."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SAMPLER_SEED * 2 ** 32 + int(cur_iter))
    rpn = torch.rand((batch_size, num_anchors), generator=gen, device=device)
    rcnn = torch.rand((batch_size, num_candidates), generator=gen,
                      device=device)
    return dict(rpn=rpn, rcnn=rcnn)


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
    draws = sampler_draws(cur_iter, scores[0].shape[0], num_anchors,
                          TRAIN_PROPOSALS + batch["gt_bboxes"].shape[1],
                          scores[0].device)
    losses = rpn_loss(detector.rpn_head, scores, deltas, batch, draws["rpn"],
                      train_cfg=dict(tc.get("rpn", {}) or {}))
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=batch.get("img_shapes"),
        nms_pre=TRAIN_PROPOSALS, num_proposals=TRAIN_PROPOSALS)
    head = detector.bbox_head
    samples = sample_batch_rois(proposals, prop_valid, batch, draws["rcnn"],
                                head.num_classes, **rcnn_kw)
    losses.update(roi_head_loss(head, head, feats, samples, batch,
                                detector.strides))
    return _parse_losses(losses)


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
    def call(*args, **kw):
        if variables is None:
            return detector(*args, **kw)
        return functional_call(detector, variables, args, kw)

    tc = dict(test_cfg or detector.test_cfg or {})
    rcnn = dict(tc.get("rcnn", {}) or {})
    nms_cfg = dict(rcnn.get("nms", {}) or {})
    feats, (scores, deltas) = call(images)
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=img_shapes,
        nms_pre=TEST_PROPOSALS, num_proposals=TEST_PROPOSALS)
    return roi_head_predict(
        detector.bbox_head, lambda rf: call(rf, stage="roi"), feats,
        proposals, prop_valid, img_shapes=img_shapes,
        scale_factors=scale_factors, strides=detector.strides,
        score_thr=rcnn.get("score_thr", 0.05),
        iou_threshold=nms_cfg.get("iou_threshold", 0.5),
        max_per_img=rcnn.get("max_per_img", 100), nms_cfg=nms_cfg)


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
