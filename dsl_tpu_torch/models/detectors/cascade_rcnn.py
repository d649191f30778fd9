"""Cascade R-CNN and Cascade Mask R-CNN.

Counterpart of ``dsl_tpu/models/detectors/cascade_rcnn.py`` (its
``CascadeRCNN`` half; ``HTC`` and ``SCNet``, built on it there, are not
ported yet and raise naming themselves, as does DetectoRS):

- ``CascadeRCNN``: backbone -> FPN -> RPN, one bbox head per stage at
  mmdet's ``roi_head.bbox_head.{i}`` and, for Cascade Mask R-CNN, one
  ``FCNMaskHead`` at ``roi_head.mask_head`` that every stage shares: the
  JAX package keeps one mask head where mmdet keeps one per stage, and the
  port follows it (an mmdet checkpoint's ``roi_head.mask_head.{i}`` keys
  raise on load rather than fill one head from one stage);
- ``build_cascade_rcnn``: a ``Shared*`` stage defaults to the
  class-agnostic regressor and SmoothL1(beta 1), mmdet's cascade stages;
  ``stage_loss_weights`` (1, 0.5, 0.25) and ``stage_ious`` (0.5, 0.6, 0.7)
  cut to the number of stages, or the config's, one per stage;
- ``decode_stage``: one stage's refinement, class-agnostic, the class mean,
  or at the given labels (a SABL stage is refused when the detector is
  built);
- ``cascade_rcnn_loss``: the RPN loss, 512 proposals (no gradient), then
  per stage 256 samples (the stage's own ``train_cfg.rcnn`` entry, or the
  IoU ladder with ``min_pos_iou`` the stage's IoU and no low-quality
  match), the RoI head's losses and, with masks in the batch, the shared
  mask head's, each ``s{i}.``-prefixed and weighted by the stage. Between
  stages every proposal (not only the sampled ones, as in mmdet) is
  refined by the stage's head, unclipped, as in the JAX package. The
  samplers draw :func:`two_stage.sampler_draws` with one tensor per stage;
- ``cascade_decode_nms`` / ``cascade_rcnn_predict``: 1000 proposals; every
  stage's raw logits summed, the softmax taken once of their mean; the
  proposals refined by each stage but the last at its argmax class and
  clipped; the last stage's decode and NMS (``rcnn_decode_nms``). Two
  launches of the NMS kernel. As in the JAX package, a Cascade Mask
  R-CNN predicts boxes only.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from dsl_tpu_torch.core.boxes import clip_to_shapes, resolve_delta_coder
from dsl_tpu_torch.models.dense_heads.rpn_head import rpn_loss, rpn_proposals
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.detectors.two_stage import (
    BBOX_HEADS, TEST_PROPOSALS, TRAIN_PROPOSALS, _caller, _check_head,
    mask_branch_losses, parse_rcnn_train_cfg)
from dsl_tpu_torch.models.roi_heads.standard_roi_head import (
    extract_roi_feats, flat_rois, rcnn_decode_nms, roi_head_loss,
    sample_batch_rois)
from dsl_tpu_torch.registry import DETECTORS, MODELS, build_from_cfg

CASCADE_IOUS = (0.5, 0.6, 0.7)
CASCADE_WEIGHTS = (1.0, 0.5, 0.25)
CASCADE_SAMPLES = 256         # cascade_rcnn_loss's num_samples in JAX


class CascadeRoIHead(nn.Module):
    """The stages' bbox heads and the shared mask head under mmdet's names
    (``roi_head.bbox_head.{i}``, ``roi_head.mask_head``)."""

    def __init__(self, bbox_heads: Sequence[nn.Module],
                 mask_head: nn.Module | None = None):
        super().__init__()
        self.bbox_head = nn.ModuleList(bbox_heads)
        self.mask_head = mask_head

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        per_stage = sorted(k for k in state_dict
                           if k.startswith(f"{prefix}mask_head.")
                           and k[len(prefix) + 10:].split(".")[0].isdigit())
        if per_stage:
            raise KeyError(
                f"one mask head per stage ({per_stage[:3]}, ... "
                f"{len(per_stage)} keys): an mmdet Cascade Mask R-CNN's; the "
                f"JAX package and the port share one mask head over the "
                f"stages and do not load one stage's into it")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


@DETECTORS.register
class CascadeRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_heads: Sequence[nn.Module],
                 mask_head: nn.Module | None = None, train_cfg: Any = None,
                 test_cfg: Any = None,
                 stage_loss_weights: Sequence[float] = CASCADE_WEIGHTS,
                 stage_ious: Sequence[float] = CASCADE_IOUS):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = CascadeRoIHead(bbox_heads, mask_head)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.stage_loss_weights = tuple(stage_loss_weights)
        self.stage_ious = tuple(stage_ious)

    @property
    def bbox_heads(self) -> nn.ModuleList:
        return self.roi_head.bbox_head

    @property
    def bbox_head(self) -> nn.Module:
        """The last stage's head (its classes are the detector's)."""
        return self.roi_head.bbox_head[-1]

    @property
    def mask_head(self) -> nn.Module | None:
        return self.roi_head.mask_head

    @property
    def strides(self) -> tuple:
        """The RoI levels' strides (the RPN's first four)."""
        return tuple(self.rpn_head.strides)[:4]

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, self.neck, self.rpn_head, *self.bbox_heads,
                     self.mask_head):
            if part is not None:
                part.init_weights(generator)

    def forward(self, inputs: torch.Tensor, training: bool = False,
                stage: str = "rpn", head: int = 0):
        """``stage="rpn"``: images NCHW -> (FPN levels, (RPN scores, RPN
        deltas)); ``stage="roi"``: RoI features (N, C, s, s) -> stage
        ``head``'s (cls_logits, deltas); ``stage="mask"``: RoI features ->
        the mask head's logits (N, classes, S, S)."""
        if stage == "roi":
            return self.bbox_heads[head](inputs)
        if stage == "mask":
            return self.mask_head(inputs)
        feats = self.neck(self.backbone(inputs))
        return feats, self.rpn_head(feats, training=training)


def roi_bbox_head_cfg(model_cfg: dict) -> dict:
    """A two-stage model config's bbox head, a cascade's last stage."""
    heads = model_cfg.get("bbox_heads")
    return dict(heads[-1] if heads else model_cfg.get("bbox_head") or {})


def build_cascade_rcnn(cfg: dict) -> CascadeRCNN:
    cfg = dict(cfg)
    det_type = cfg.pop("type", "CascadeRCNN")
    if det_type in two_stage.UNPORTED_DETECTORS:
        raise NotImplementedError(f"{det_type} is not ported yet")
    if cfg.get("mask_heads") is not None:
        raise NotImplementedError("a cascade with mask_heads (HTC) is not "
                                  "ported yet")
    if det_type != "CascadeRCNN":
        raise KeyError(f"unknown cascade detector type {det_type}")
    neck_cfg = cfg.pop("neck")
    if isinstance(neck_cfg, (list, tuple)):
        raise NotImplementedError("stacked necks are not ported yet")
    if dict(neck_cfg).get("type") == "RFP":
        raise NotImplementedError("the RFP neck (DetectoRS) is not ported yet")
    _check_head(cfg, "rpn_head", ("RPNHead",))
    heads = []
    for i, c in enumerate(cfg.pop("bbox_heads")):
        c = dict(c)
        _check_head({f"bbox_heads[{i}]": c}, f"bbox_heads[{i}]", BBOX_HEADS)
        if str(c["type"]).startswith("Shared"):
            # mmdet's cascade stages: class-agnostic regression, SmoothL1
            c.setdefault("reg_class_agnostic", True)
            c.setdefault("loss_bbox", dict(type="SmoothL1Loss", beta=1.0))
        heads.append(build_from_cfg(c, MODELS))
    n = len(heads)
    weights = tuple(cfg.pop("stage_loss_weights", CASCADE_WEIGHTS[:n]))
    ious = tuple(cfg.pop("stage_ious", CASCADE_IOUS[:n]))
    if len(weights) != n or len(ious) != n:
        raise ValueError(f"stage_loss_weights/stage_ious must have {n} "
                         f"entries")
    mask_cfg = cfg.pop("mask_head", None)
    if mask_cfg is not None:
        _check_head(dict(mask_head=mask_cfg), "mask_head", ("FCNMaskHead",))
    return CascadeRCNN(
        backbone=build_from_cfg(dict(cfg.pop("backbone")), MODELS),
        neck=build_from_cfg(dict(neck_cfg), MODELS),
        rpn_head=build_from_cfg(dict(cfg.pop("rpn_head")), MODELS),
        bbox_heads=heads,
        mask_head=build_from_cfg(dict(mask_cfg), MODELS) if mask_cfg else None,
        train_cfg=cfg.pop("train_cfg", None),
        test_cfg=cfg.pop("test_cfg", None),
        stage_loss_weights=weights, stage_ious=ious)


def decode_stage(head, proposals: torch.Tensor, reg: torch.Tensor,
                 labels: torch.Tensor | None = None) -> torch.Tensor:
    """One stage's refined boxes (B, P, 4) from proposals (B, P, 4) and its
    deltas (B*P, 4) class-agnostic, else (B*P, 4C) at ``labels`` (B, P), or
    their mean over the classes without labels."""
    _, dec, means, stds = resolve_delta_coder(
        head.bbox_coder, head.target_means, head.target_stds)
    b, p = proposals.shape[:2]
    if head.reg_class_agnostic:
        return dec(proposals, reg.reshape(b, p, 4), means, stds)
    reg = reg.reshape(b, p, head.num_classes, 4)
    if labels is None:
        sel = reg.mean(2)
    else:
        sel = torch.gather(reg, 2, labels[..., None, None].expand(
            b, p, 1, 4))[:, :, 0]
    return dec(proposals, sel, means, stds)


def stage_rcnn_kw(detector: CascadeRCNN, stage: int,
                  num_samples: int | None = CASCADE_SAMPLES) -> dict:
    """A stage's sampling keywords: its entry of a list ``train_cfg.rcnn``,
    or a single ``train_cfg.rcnn`` for every stage, or the IoU ladder
    (``min_pos_iou`` the stage's IoU, no low-quality match); the sample
    count ``num_samples`` wins where given."""
    tc = dict(detector.train_cfg or {})
    rc = tc.get("rcnn")
    if isinstance(rc, (list, tuple)):
        kw = parse_rcnn_train_cfg(None, stage_cfg=rc[stage])
    elif rc is not None:
        kw = parse_rcnn_train_cfg(tc)
    else:
        iou = detector.stage_ious[stage]
        kw = dict(num_samples=512, pos_fraction=0.25, add_gt_as_proposals=True,
                  pos_iou_thr=iou, neg_iou_thr=iou, min_pos_iou=iou,
                  match_low_quality=False)
    if num_samples is not None:
        kw["num_samples"] = num_samples
    return kw


def cascade_rcnn_loss(detector: CascadeRCNN, batch: dict, cur_iter: int = 0,
                      mark=None):
    """The Cascade (Mask) R-CNN training loss (see the module's docstring),
    the losses and the log vars as ``single_stage._parse_losses`` gives
    them. ``mark("forward")``, where given, is called once the forward is
    enqueued."""
    from dsl_tpu_torch.models.detectors.single_stage import _parse_losses

    tc = dict(detector.train_cfg or {})
    feats, (scores, deltas) = detector(batch["images"], training=True)
    if mark is not None:
        mark("forward")
    n_stages = len(detector.bbox_heads)
    draws = two_stage.sampler_draws(
        cur_iter, scores[0].shape[0], sum(s[0].numel() for s in scores),
        TRAIN_PROPOSALS + batch["gt_bboxes"].shape[1], scores[0].device,
        stages=n_stages)
    losses = rpn_loss(detector.rpn_head, scores, deltas, batch, draws["rpn"],
                      train_cfg=dict(tc.get("rpn", {}) or {}))
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=batch.get("img_shapes"),
        nms_pre=TRAIN_PROPOSALS, num_proposals=TRAIN_PROPOSALS)
    proposals = proposals.detach()
    masks = detector.mask_head is not None and "gt_mask_crops" in batch
    for stage, head in enumerate(detector.bbox_heads):
        w = detector.stage_loss_weights[stage]
        call = lambda rf, _s=stage: detector(  # noqa: E731
            rf, stage="roi", head=_s)
        samples = sample_batch_rois(proposals, prop_valid, batch,
                                    draws["rcnn"][stage], head.num_classes,
                                    **stage_rcnn_kw(detector, stage))
        stage_losses = roi_head_loss(head, call, feats, samples, batch,
                                     detector.strides)
        if masks:
            losses[f"s{stage}.loss_mask"] = w * mask_branch_losses(
                detector, feats, samples, batch, CASCADE_SAMPLES)["loss_mask"]
        for k, v in stage_losses.items():
            losses[f"s{stage}.{k}"] = v * w if "loss" in k else v
        if stage < n_stages - 1:
            with torch.no_grad():
                rfeats = extract_roi_feats(feats, flat_rois(proposals),
                                           prop_valid.reshape(-1),
                                           detector.strides, head.roi_size)
                proposals = decode_stage(head, proposals, call(rfeats)[1])
    return _parse_losses(losses)


def cascade_decode_nms(heads, stage_fn, proposals, prop_valid, img_shapes=None,
                       scale_factors=None, test_cfg: dict | None = None):
    """The cascade's decode and NMS: ``stage_fn(stage, proposals (B, P, 4))
    -> (cls_logits (B*P, C+1), reg)`` per stage; the raw logits' mean over
    the stages, softmax once (of the mean, not the mean of the softmaxes);
    each stage but the last refines the proposals at its own argmax class
    (``[:, :C]``), clipped to ``img_shapes``; the last stage's deltas
    through ``rcnn_decode_nms``. Returns dets (B, max_per_img, 5), labels,
    valid."""
    tc = dict(test_cfg or {})
    rcnn = dict(tc.get("rcnn", tc) or {})
    nms_cfg = dict(rcnn.get("nms", {}) or {})
    b, p = proposals.shape[:2]
    logits_sum, reg = None, None
    for stage, head in enumerate(heads):
        cls_logits, reg = stage_fn(stage, proposals)
        logits_sum = (cls_logits if logits_sum is None
                      else logits_sum + cls_logits)
        if stage < len(heads) - 1:
            labels = cls_logits[:, :head.num_classes].argmax(-1).reshape(b, p)
            proposals = decode_stage(head, proposals, reg, labels)
            if img_shapes is not None:
                proposals = clip_to_shapes(proposals, img_shapes)
    # divided by a device tensor: a python divisor becomes a product by its
    # reciprocal on the card
    mean_logits = logits_sum / logits_sum.new_full((), float(len(heads)))
    return rcnn_decode_nms(
        heads[-1], mean_logits, reg, proposals, prop_valid,
        img_shapes=img_shapes, scale_factors=scale_factors,
        score_thr=float(rcnn.get("score_thr", 0.05)),
        iou_threshold=float(nms_cfg.get("iou_threshold", 0.5)),
        max_per_img=int(rcnn.get("max_per_img", 100)), nms_cfg=nms_cfg)


@torch.no_grad()
def cascade_rcnn_predict(detector: CascadeRCNN, images: torch.Tensor,
                         img_shapes=None, scale_factors=None,
                         test_cfg: dict | None = None,
                         variables: dict | None = None):
    """RPN proposals (1000 per image), then :func:`cascade_decode_nms` over
    the stages: dets (B, max_per_img, 5), labels, valid. ``variables``
    (name -> tensor) replace the detector's own where given. Two launches
    of the NMS kernel."""
    call = _caller(detector, variables)
    feats, (scores, deltas) = call(images)
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=img_shapes,
        nms_pre=TEST_PROPOSALS, num_proposals=TEST_PROPOSALS)
    valid = prop_valid.reshape(-1)

    def stage_fn(stage, props):
        rfeats = extract_roi_feats(feats, flat_rois(props), valid,
                                   detector.strides,
                                   detector.bbox_heads[stage].roi_size)
        return call(rfeats, stage="roi", head=stage)

    return cascade_decode_nms(detector.bbox_heads, stage_fn, proposals,
                              prop_valid, img_shapes=img_shapes,
                              scale_factors=scale_factors,
                              test_cfg=test_cfg or detector.test_cfg)
