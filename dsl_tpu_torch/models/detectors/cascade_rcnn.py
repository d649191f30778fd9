"""Cascade R-CNN, Cascade Mask R-CNN, HTC and SCNet.

Counterpart of ``dsl_tpu/models/detectors/cascade_rcnn.py``:

- ``CascadeRCNN``: backbone -> FPN -> RPN, one bbox head per stage at
  mmdet's ``roi_head.bbox_head.{i}`` and, for Cascade Mask R-CNN, one
  ``FCNMaskHead`` at ``roi_head.mask_head`` that every stage shares: the
  JAX package keeps one mask head where mmdet keeps one per stage, and the
  port follows it (an mmdet checkpoint's ``roi_head.mask_head.{i}`` keys
  raise on load rather than fill one head from one stage). With the RFP
  neck (DetectoRS) the neck reads ``(image, C2..C5)``;
- ``build_cascade_rcnn``: a ``Shared*`` stage defaults to the
  class-agnostic regressor and SmoothL1(beta 1), mmdet's cascade stages;
  ``stage_loss_weights`` (1, 0.5, 0.25) and ``stage_ious`` (0.5, 0.6, 0.7)
  cut to the number of stages, or the config's, one per stage. As in the
  JAX package a config with ``mask_heads`` is an HTC whatever its type
  (DetectoRS-HTC keeps ``type='DetectoRS'``), ``type='SCNet'`` an SCNet,
  and ``CascadeRCNN`` or ``DetectoRS`` without ``mask_heads`` a Cascade
  R-CNN; another type raises;
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
  R-CNN predicts boxes only;
- ``HTC`` (``htc_loss``, ``htc_predict``): one ``HTCMaskHead`` per stage at
  ``roi_head.mask_head.{i}`` and the ``FusedSemanticHead`` at
  ``roi_head.semantic_head``. The semantic target is never a loaded
  ``gt_semantic_seg`` (the data layer drops it, as the JAX package's
  does): it is the union of the pasted GT crops at the logits' size,
  ``clip(label + 1, 0, C - 1)`` where a crop is over 0.5, the largest over
  the GTs, 0 elsewhere. The semantic embedding's stride-8 RoIAlign is
  added to the sampled RoIs' box features and to the mask features, not
  in the refinement between stages nor to the boxes in predict (mmdet
  fuses it there too; the JAX package does not). Stage ``s``'s mask loss
  runs heads ``0..s`` on the same features, each head's features feeding
  the next, nothing detached; predict gives the cascade's boxes and the
  mean of the three heads' sigmoids at the detections' class: the
  ``mask_rcnn_predict`` 4-tuple, the boxes rescaled after the mask
  features are taken. The stage losses are ``loss_cls`` and ``loss_bbox``
  (no ``acc``), as in the JAX package;
- ``SCNet`` (``scnet_loss``, ``scnet_predict``): every RoI feature (the
  samples', the refinement's, predict's and the mask's) gets the semantic
  RoIAlign and its image's pooled global context (``roi_head.glbctx_head``,
  ``loss_glbctx``); the stages' heads are class-specific
  (``SCNetBBoxHead``), so the refinement decodes the class mean of the
  deltas; one mask head on the last stage's positives, given the relayed
  ``shared_fcs.1`` features of the last box head on those RoIs
  (``roi_head.feat_relay_head``); predict takes the mask features at the
  detections scaled back to the input. The JAX package draws SCNet's
  stages from a 4-way split of its key (the cascade's from a 3-way one);
  the port's draws are :func:`two_stage.sampler_draws`' for every cascade.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from dsl_tpu_torch.core.boxes import clip_to_shapes, resolve_delta_coder
from dsl_tpu_torch.models.dense_heads.rpn_head import rpn_loss, rpn_proposals
from dsl_tpu_torch.models.dense_heads.yolact_head import paste_gt_crops
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.detectors.two_stage import (
    BBOX_HEADS, TEST_PROPOSALS, TRAIN_PROPOSALS, _caller, _check_head,
    class_probs, mask_branch_losses, parse_rcnn_train_cfg)
from dsl_tpu_torch.models.roi_heads.htc import semantic_seg_loss
from dsl_tpu_torch.models.roi_heads.mask_head import (
    mask_head_loss, select_positive_rois)
from dsl_tpu_torch.models.roi_heads.scnet import global_context_loss
from dsl_tpu_torch.models.roi_heads.standard_roi_head import (
    extract_roi_feats, flat_rois, rcnn_bbox_loss, rcnn_decode_nms,
    roi_head_loss, sample_batch_rois)
from dsl_tpu_torch.ops.roi_align import roi_align
from dsl_tpu_torch.registry import DETECTORS, MODELS, build_from_cfg

CASCADE_IOUS = (0.5, 0.6, 0.7)
CASCADE_WEIGHTS = (1.0, 0.5, 0.25)
CASCADE_SAMPLES = 256         # cascade_rcnn_loss's num_samples in JAX
SEMANTIC_STRIDE = 8           # the semantic embedding's RoIAlign stride
CASCADE_TYPES = ("CascadeRCNN", "DetectoRS")  # built as a Cascade R-CNN


class CascadeRoIHead(nn.Module):
    """The stages' bbox heads and the mask head (one shared, or one per
    stage for HTC) under mmdet's names (``roi_head.bbox_head.{i}``,
    ``roi_head.mask_head`` or ``roi_head.mask_head.{i}``), and HTC's and
    SCNet's branches (``semantic_head``, ``glbctx_head``,
    ``feat_relay_head``) where the detector has them."""

    def __init__(self, bbox_heads: Sequence[nn.Module],
                 mask_head: nn.Module | Sequence[nn.Module] | None = None,
                 semantic_head: nn.Module | None = None,
                 glbctx_head: nn.Module | None = None,
                 feat_relay_head: nn.Module | None = None):
        super().__init__()
        self.bbox_head = nn.ModuleList(bbox_heads)
        self.mask_head = (nn.ModuleList(mask_head)
                          if isinstance(mask_head, (list, tuple)) else mask_head)
        self.semantic_head = semantic_head
        self.glbctx_head = glbctx_head
        self.feat_relay_head = feat_relay_head

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        per_stage = sorted(k for k in state_dict
                           if k.startswith(f"{prefix}mask_head.")
                           and k[len(prefix) + 10:].split(".")[0].isdigit())
        if per_stage and not isinstance(self.mask_head, nn.ModuleList):
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
                 stage_ious: Sequence[float] = CASCADE_IOUS, **branches):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = CascadeRoIHead(bbox_heads, mask_head, **branches)
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
                     *self.roi_head.children()):
            if part is not None and not isinstance(part, nn.ModuleList):
                part.init_weights(generator)
        if isinstance(self.mask_head, nn.ModuleList):
            for head in self.mask_head:
                head.init_weights(generator)

    def extract_feat(self, images: torch.Tensor):
        feats = self.backbone(images)
        if type(self.neck).__name__ == "RFP":
            return self.neck((images, *feats))
        return self.neck(feats)

    def forward(self, inputs, training: bool = False, stage: str = "rpn",
                head: int = 0, res_feat: torch.Tensor | None = None,
                shared: bool = False):
        """``stage="rpn"``: images NCHW -> (FPN levels, (RPN scores, RPN
        deltas)); ``stage="roi"``: RoI features (N, C, s, s) -> stage
        ``head``'s (cls_logits, deltas) (and an SCNet head's shared
        features with ``shared``); ``stage="mask"``: RoI features -> the
        mask head's logits (N, classes, S, S); ``"htc_mask"``: RoI features
        and ``res_feat`` -> HTC mask head ``head``'s (logits, features);
        ``"semantic"`` / ``"glbctx"``: the FPN levels -> the semantic
        head's (logits, embedding) / the global-context head's (logits,
        pooled); ``"relay"``: shared FC features -> the relay head's map.
        One forward for all, so that ``functional_call`` can run each with
        other parameters."""
        if stage == "roi":
            bbox_head = self.bbox_heads[head]
            return (bbox_head(inputs, return_shared_feat=True) if shared
                    else bbox_head(inputs))
        if stage == "mask":
            return self.mask_head(inputs)
        if stage == "htc_mask":
            return self.mask_head[head](inputs, res_feat)
        if stage == "semantic":
            return self.roi_head.semantic_head(inputs)
        if stage == "glbctx":
            return self.roi_head.glbctx_head(inputs)
        if stage == "relay":
            return self.roi_head.feat_relay_head(inputs)
        feats = self.extract_feat(inputs)
        return feats, self.rpn_head(feats, training=training)


@DETECTORS.register
class HTC(CascadeRCNN):
    """Hybrid Task Cascade (``mmdet/models/detectors/htc.py``): the cascade,
    a mask head per stage with the mask information flow, and the fused
    semantic branch (absent in ``htc_without_semantic``)."""

    @property
    def mask_heads(self) -> nn.ModuleList:
        return self.roi_head.mask_head

    @property
    def semantic_head(self) -> nn.Module | None:
        return self.roi_head.semantic_head


@DETECTORS.register
class SCNet(CascadeRCNN):
    """SCNet (``mmdet/models/detectors/scnet.py``): the cascade with the
    semantic and global-context branches fused into every RoI feature, and
    one mask head fed the last box head's relayed features."""

    @property
    def semantic_head(self) -> nn.Module:
        return self.roi_head.semantic_head

    @property
    def glbctx_head(self) -> nn.Module:
        return self.roi_head.glbctx_head

    @property
    def relay_head(self) -> nn.Module:
        return self.roi_head.feat_relay_head


def roi_bbox_head_cfg(model_cfg: dict) -> dict:
    """A two-stage model config's bbox head, a cascade's last stage."""
    heads = model_cfg.get("bbox_heads")
    return dict(heads[-1] if heads else model_cfg.get("bbox_head") or {})


def build_cascade_rcnn(cfg: dict) -> CascadeRCNN:
    cfg = dict(cfg)
    det_type = cfg.pop("type", "CascadeRCNN")
    if det_type in two_stage.UNPORTED_DETECTORS:
        raise NotImplementedError(f"{det_type} is not ported yet")
    htc = det_type in ("HTC", "HybridTaskCascade") or "mask_heads" in cfg
    if not htc and det_type not in CASCADE_TYPES + ("SCNet",):
        raise KeyError(f"unknown cascade detector type {det_type}")
    neck_cfg = cfg.pop("neck")
    if isinstance(neck_cfg, (list, tuple)):
        raise NotImplementedError(
            "a list neck on a cascade: the JAX package's cascade builder "
            "takes none")
    _check_head(cfg, "rpn_head", ("RPNHead",))
    heads = []
    for i, c in enumerate(cfg.pop("bbox_heads")):
        c = dict(c)
        _check_head({f"bbox_heads[{i}]": c}, f"bbox_heads[{i}]",
                    BBOX_HEADS + ("SCNetBBoxHead",))
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
    parts = dict(
        backbone=build_from_cfg(dict(cfg.pop("backbone")), MODELS),
        neck=build_from_cfg(dict(neck_cfg), MODELS),
        rpn_head=build_from_cfg(dict(cfg.pop("rpn_head")), MODELS),
        bbox_heads=heads, train_cfg=cfg.pop("train_cfg", None),
        test_cfg=cfg.pop("test_cfg", None), stage_loss_weights=weights,
        stage_ious=ious)
    if det_type == "SCNet":
        _check_head(dict(mask_head=mask_cfg), "mask_head", ("SCNetMaskHead",))
        return SCNet(
            mask_head=build_from_cfg(dict(mask_cfg), MODELS),
            semantic_head=build_from_cfg(dict(cfg.pop("semantic_head")),
                                         MODELS),
            glbctx_head=build_from_cfg(dict(cfg.pop("glbctx_head")), MODELS),
            feat_relay_head=build_from_cfg(dict(cfg.pop("relay_head")),
                                           MODELS), **parts)
    if htc:
        # a single mask_head beside them is dropped, as the JAX package does
        mask_heads = [dict(c) for c in cfg.pop("mask_heads")]
        for i, c in enumerate(mask_heads):
            _check_head({f"mask_heads[{i}]": c}, f"mask_heads[{i}]",
                        ("HTCMaskHead",))
        sem_cfg = cfg.pop("semantic_head", None)
        return HTC(
            mask_head=[build_from_cfg(c, MODELS) for c in mask_heads],
            semantic_head=(build_from_cfg(dict(sem_cfg), MODELS) if sem_cfg
                           else None), **parts)
    if mask_cfg is not None:
        _check_head(dict(mask_head=mask_cfg), "mask_head", ("FCNMaskHead",))
    return CascadeRCNN(
        mask_head=build_from_cfg(dict(mask_cfg), MODELS) if mask_cfg else None,
        **parts)


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

    feats, draws, losses, proposals, prop_valid = _train_begin(
        detector, batch, cur_iter, mark)
    n_stages = len(detector.bbox_heads)
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
    return _cascade_boxes(detector, call, call(images), img_shapes,
                          scale_factors, test_cfg)


def _cascade_boxes(detector: CascadeRCNN, call, outputs, img_shapes,
                   scale_factors, test_cfg, fuse=None):
    """The cascade's dets, labels and valid from the forward's ``outputs``
    (levels, (RPN scores, deltas)); ``fuse(roi_feats, rois, valid,
    roi_size)``, where given, is added to every stage's RoI features."""
    feats, (scores, deltas) = outputs
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=img_shapes,
        nms_pre=TEST_PROPOSALS, num_proposals=TEST_PROPOSALS)
    valid = prop_valid.reshape(-1)

    def stage_fn(stage, props):
        size = detector.bbox_heads[stage].roi_size
        rois = flat_rois(props)
        rfeats = extract_roi_feats(feats, rois, valid, detector.strides, size)
        if fuse is not None:
            rfeats = fuse(rfeats, rois, valid, size)
        return call(rfeats, stage="roi", head=stage)

    return cascade_decode_nms(detector.bbox_heads, stage_fn, proposals,
                              prop_valid, img_shapes=img_shapes,
                              scale_factors=scale_factors,
                              test_cfg=test_cfg or detector.test_cfg)


# -- HTC ----------------------------------------------------------------------

def semantic_roi_feats(semantic_feat: torch.Tensor | None, rois: torch.Tensor,
                       valid: torch.Tensor, roi_size: int):
    """The semantic embedding's RoIAlign at stride 8 (``sampling_ratio``
    2), (N, C, s, s); 0 without a semantic head."""
    if semantic_feat is None:
        return 0.0
    return roi_align(semantic_feat, rois, out_size=(roi_size, roi_size),
                     spatial_scale=1.0 / SEMANTIC_STRIDE, sampling_ratio=2,
                     valid=valid)


def htc_semantic_target(num_classes: int, batch: dict, seg_hw) -> torch.Tensor:
    """(B, h, w) int64: ``clip(label + 1, 0, num_classes - 1)`` where a
    valid GT's crop pasted at its box (``yolact_head.paste_gt_crops``) is
    over 0.5, the largest over the GTs, 0 elsewhere."""
    if "gt_mask_crops" not in batch:
        raise KeyError("gt_mask_crops: HTC's and SCNet's semantic target is "
                       "made from the GT masks, so their train pipeline "
                       "loads masks (LoadAnnotations(with_mask=True)), as in "
                       "the JAX package")
    img_hw = tuple(batch["images"].shape[2:4])
    pasted = paste_gt_crops(batch["gt_mask_crops"], batch["gt_bboxes"],
                            batch["gt_valid"], seg_hw, img_hw)
    lbl = (batch["gt_labels"].to(torch.int64) + 1).clamp(0, num_classes - 1)
    per_gt = torch.where(pasted > 0.5, lbl[:, :, None, None],
                         lbl.new_zeros(()))
    return per_gt.amax(1)


def _semantic_loss(detector, feats, batch: dict, losses: dict):
    """The semantic branch: its embedding, and ``loss_semantic_seg`` into
    ``losses``."""
    head = detector.semantic_head
    seg_logits, semantic_feat = detector(feats, stage="semantic")
    target = htc_semantic_target(head.num_classes, batch,
                                 tuple(seg_logits.shape[2:4]))
    losses["loss_semantic_seg"] = semantic_seg_loss(
        seg_logits, target, loss_weight=head.loss_weight)
    return semantic_feat


def _mask_rois(samples: dict, max_pos: int):
    """The positives-first RoIs of the mask branch: (rois (B*max_pos, 5),
    labels, assigned, positives, each (B*max_pos,))."""
    rois, labels, assigned, is_pos = select_positive_rois(
        samples["rois"], samples["labels"], samples["assigned"],
        samples["is_pos"], max_pos)
    return (flat_rois(rois), labels.reshape(-1), assigned.reshape(-1),
            is_pos.reshape(-1))


def _mask_targets(batch: dict, rois: torch.Tensor, assigned: torch.Tensor,
                  mask_size: int) -> torch.Tensor:
    return two_stage.mask_targets_from_crops(
        batch["gt_mask_crops"], batch["gt_bboxes"], rois[:, 1:5],
        rois[:, 0].to(torch.int64), assigned, mask_size=mask_size)


def _train_begin(detector, batch: dict, cur_iter: int, mark):
    """The training forward, the samplers' draws, the RPN loss and the 512
    proposals (no gradient)."""
    tc = dict(detector.train_cfg or {})
    feats, (scores, deltas) = detector(batch["images"], training=True)
    if mark is not None:
        mark("forward")
    draws = two_stage.sampler_draws(
        cur_iter, scores[0].shape[0], sum(s[0].numel() for s in scores),
        TRAIN_PROPOSALS + batch["gt_bboxes"].shape[1], scores[0].device,
        stages=len(detector.bbox_heads))
    losses = rpn_loss(detector.rpn_head, scores, deltas, batch, draws["rpn"],
                      train_cfg=dict(tc.get("rpn", {}) or {}))
    proposals, _, prop_valid = rpn_proposals(
        detector.rpn_head, scores, deltas, img_shapes=batch.get("img_shapes"),
        nms_pre=TRAIN_PROPOSALS, num_proposals=TRAIN_PROPOSALS)
    return feats, draws, losses, proposals.detach(), prop_valid


def htc_loss(detector: HTC, batch: dict, cur_iter: int = 0, mark=None):
    """HTC's training loss (see the module's docstring), as
    ``single_stage._parse_losses`` gives it."""
    from dsl_tpu_torch.models.detectors.single_stage import _parse_losses

    feats, draws, losses, proposals, prop_valid = _train_begin(
        detector, batch, cur_iter, mark)
    semantic_feat = (None if detector.semantic_head is None else
                     _semantic_loss(detector, feats, batch, losses))
    masks = "gt_mask_crops" in batch
    n_stages = len(detector.bbox_heads)
    for stage, head in enumerate(detector.bbox_heads):
        w = detector.stage_loss_weights[stage]
        samples = sample_batch_rois(proposals, prop_valid, batch,
                                    draws["rcnn"][stage], head.num_classes,
                                    **stage_rcnn_kw(detector, stage))
        rois = flat_rois(samples["rois"])
        valid = samples["valid"].reshape(-1)
        rfeats = (extract_roi_feats(feats, rois, valid, detector.strides,
                                    head.roi_size)
                  + semantic_roi_feats(semantic_feat, rois, valid,
                                       head.roi_size))
        out = rcnn_bbox_loss(head, *detector(rfeats, stage="roi", head=stage),
                             samples, batch)
        losses[f"s{stage}.loss_cls"] = w * out["loss_cls"]
        losses[f"s{stage}.loss_bbox"] = w * out["loss_bbox"]
        if masks:
            mh = detector.mask_heads[stage]
            prois, plabels, passigned, ppos = _mask_rois(
                samples, max(1, CASCADE_SAMPLES // 4))
            mfeats = (extract_roi_feats(feats, prois, ppos, detector.strides,
                                        mh.roi_size)
                      + semantic_roi_feats(semantic_feat, prois, ppos,
                                           mh.roi_size))
            res_feat = None
            for j in range(stage + 1):        # the mask information flow
                logits, res_feat = detector(mfeats, stage="htc_mask", head=j,
                                            res_feat=res_feat)
            targets = _mask_targets(batch, prois, passigned, logits.shape[-1])
            losses[f"s{stage}.loss_mask"] = w * mask_head_loss(
                logits, targets, plabels, ppos.to(torch.float32),
                mh.num_classes)
        if stage < n_stages - 1:
            with torch.no_grad():
                rfeats = extract_roi_feats(feats, flat_rois(proposals),
                                           prop_valid.reshape(-1),
                                           detector.strides, head.roi_size)
                proposals = decode_stage(
                    head, proposals, detector(rfeats, stage="roi",
                                              head=stage)[1])
    return _parse_losses(losses)


@torch.no_grad()
def htc_predict(detector: HTC, images: torch.Tensor, img_shapes=None,
                scale_factors=None, test_cfg: dict | None = None,
                variables: dict | None = None):
    """The cascade's boxes, then the mean of the mask heads' probabilities
    at the detections' class: dets (B, N, 5) in the original frame,
    labels, valid and probabilities (B, N, S, S). Two launches of the NMS
    kernel."""
    from dsl_tpu_torch.models.detectors.single_stage import (
        check_predict_device)

    check_predict_device(detector, images, images.device)
    call = _caller(detector, variables)
    outputs = call(images)
    dets, labels, valid = _cascade_boxes(detector, call, outputs, img_shapes,
                                         None, test_cfg)
    feats = outputs[0]
    semantic_feat = (None if detector.semantic_head is None
                     else call(feats, stage="semantic")[1])
    heads = detector.mask_heads
    b, n = dets.shape[:2]
    rois, v = flat_rois(dets[..., :4]), valid.reshape(-1)
    size = heads[0].roi_size
    mfeats = (extract_roi_feats(feats, rois, v, detector.strides, size)
              + semantic_roi_feats(semantic_feat, rois, v, size))
    res_feat, prob_sum = None, None
    for j, head in enumerate(heads):
        logits, res_feat = call(mfeats, stage="htc_mask", head=j,
                                res_feat=res_feat)
        p = class_probs(logits, labels, head.num_classes)
        prob_sum = p if prob_sum is None else prob_sum + p
    # divided by a device tensor: a python divisor becomes a product by its
    # reciprocal on the card
    probs = prob_sum / prob_sum.new_full((), float(len(heads)))
    if scale_factors is not None:
        dets = torch.cat([dets[..., :4] / scale_factors[:, None, :],
                          dets[..., 4:]], dim=-1)
    s = probs.shape[-1]
    return dets, labels, valid, probs.reshape(b, n, s, s)


# -- SCNet ----------------------------------------------------------------------

def _scnet_fuser(semantic_feat: torch.Tensor, glbctx: torch.Tensor):
    """RoI features + the semantic RoIAlign + their image's pooled global
    context."""
    def fuse(roi_feats, rois, valid, roi_size):
        img = rois[:, 0].to(torch.int64)
        return (roi_feats + semantic_roi_feats(semantic_feat, rois, valid,
                                               roi_size)
                + glbctx[img][:, :, None, None])
    return fuse


def _scnet_mask_logits(detector: SCNet, call, feats, fuse, rois, valid):
    """The mask head's logits at ``rois``: its fused features plus the
    relayed shared features of the last box head on the same RoIs."""
    mh, bh = detector.mask_head, detector.bbox_heads[-1]
    mfeats = fuse(extract_roi_feats(feats, rois, valid, detector.strides,
                                    mh.roi_size), rois, valid, mh.roi_size)
    bfeats = fuse(extract_roi_feats(feats, rois, valid, detector.strides,
                                    bh.roi_size), rois, valid, bh.roi_size)
    shared = call(bfeats, stage="roi", head=len(detector.bbox_heads) - 1,
                  shared=True)[2]
    return call(mfeats + call(shared, stage="relay"), stage="mask")


def scnet_loss(detector: SCNet, batch: dict, cur_iter: int = 0, mark=None):
    """SCNet's training loss (see the module's docstring), as
    ``single_stage._parse_losses`` gives it."""
    from dsl_tpu_torch.models.detectors.single_stage import _parse_losses

    feats, draws, losses, proposals, prop_valid = _train_begin(
        detector, batch, cur_iter, mark)
    semantic_feat = _semantic_loss(detector, feats, batch, losses)
    glb_logits, glbctx = detector(feats, stage="glbctx")
    gh = detector.glbctx_head
    losses["loss_glbctx"] = global_context_loss(
        glb_logits, batch["gt_labels"], batch["gt_valid"].to(torch.float32),
        gh.num_classes, loss_weight=gh.loss_weight)
    fuse = _scnet_fuser(semantic_feat, glbctx)
    n_stages = len(detector.bbox_heads)
    samples = None
    for stage, head in enumerate(detector.bbox_heads):
        w = detector.stage_loss_weights[stage]
        samples = sample_batch_rois(proposals, prop_valid, batch,
                                    draws["rcnn"][stage], head.num_classes,
                                    **stage_rcnn_kw(detector, stage))
        rois = flat_rois(samples["rois"])
        valid = samples["valid"].reshape(-1)
        rfeats = fuse(extract_roi_feats(feats, rois, valid, detector.strides,
                                        head.roi_size), rois, valid,
                      head.roi_size)
        out = rcnn_bbox_loss(head, *detector(rfeats, stage="roi", head=stage),
                             samples, batch)
        losses[f"s{stage}.loss_cls"] = w * out["loss_cls"]
        losses[f"s{stage}.loss_bbox"] = w * out["loss_bbox"]
        if stage < n_stages - 1:
            with torch.no_grad():
                rois, valid = flat_rois(proposals), prop_valid.reshape(-1)
                rfeats = fuse(extract_roi_feats(
                    feats, rois, valid, detector.strides, head.roi_size),
                    rois, valid, head.roi_size)
                proposals = decode_stage(
                    head, proposals, detector(rfeats, stage="roi",
                                              head=stage)[1])
    if "gt_mask_crops" in batch:
        prois, plabels, passigned, ppos = _mask_rois(
            samples, max(1, CASCADE_SAMPLES // 4))
        logits = _scnet_mask_logits(detector, detector, feats, fuse, prois,
                                    ppos)
        targets = _mask_targets(batch, prois, passigned, logits.shape[-1])
        losses["loss_mask"] = mask_head_loss(
            logits, targets, plabels, ppos.to(torch.float32),
            detector.mask_head.num_classes)
    return _parse_losses(losses)


@torch.no_grad()
def scnet_predict(detector: SCNet, images: torch.Tensor, img_shapes=None,
                  scale_factors=None, test_cfg: dict | None = None,
                  variables: dict | None = None):
    """The cascade with SCNet's fusion, then the mask head at the
    detections scaled back to the input: dets (B, N, 5) in the original
    frame, labels, valid and probabilities (B, N, S, S). Two launches of
    the NMS kernel."""
    from dsl_tpu_torch.models.detectors.single_stage import (
        check_predict_device)

    check_predict_device(detector, images, images.device)
    call = _caller(detector, variables)
    outputs = call(images)
    feats = outputs[0]
    fuse = _scnet_fuser(call(feats, stage="semantic")[1],
                        call(feats, stage="glbctx")[1])
    dets, labels, valid = _cascade_boxes(detector, call, outputs, img_shapes,
                                         scale_factors, test_cfg, fuse=fuse)
    b, n = dets.shape[:2]
    boxes_in = dets[..., :4]
    if scale_factors is not None:
        boxes_in = boxes_in * scale_factors[:, None, :]
    logits = _scnet_mask_logits(detector, call, feats, fuse,
                                flat_rois(boxes_in), valid.reshape(-1))
    probs = class_probs(logits, labels, detector.mask_head.num_classes)
    s = probs.shape[-1]
    return dets, labels, valid, probs.reshape(b, n, s, s)
