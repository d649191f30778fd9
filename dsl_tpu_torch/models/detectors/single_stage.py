"""Single-stage detectors (FCOS, RetinaNet, SSD, YOLACT, VFNet),
build_detector, and the detectors' loss and predict entry points.

Counterpart of ``dsl_tpu/models/detectors/single_stage.py``:
``SingleStageDetector`` / ``FCOS`` / ``RetinaNet`` / ``SSD`` (backbone ->
neck, where there is one -> head), ``YOLACT`` (the head's three outputs,
then the protonet's prototypes and the segm head's logits, both on P3;
mmdet calls the protonet ``mask_head``), ``build_detector`` (which hands a
config with an ``rpn_head`` and ``bbox_heads`` to
``cascade_rcnn.build_cascade_rcnn``, one with an ``rpn_head`` or of type
``FastRCNN`` to ``two_stage.build_two_stage_detector`` and a multi-head
config to ``multi_head.py``, as the JAX package does), and
``detector_loss`` / ``detector_predict``, which route an HTC to
``htc_loss`` / ``htc_predict`` and an SCNet to ``scnet_loss`` /
``scnet_predict`` (whose predicts give the ``mask_rcnn_predict`` 4-tuple,
as the JAX package's do), a Cascade R-CNN to
``cascade_rcnn_loss`` / ``cascade_rcnn_predict``, a two-stage detector to
``two_stage_loss`` / ``two_stage_predict``, the standalone ``RPN`` to
``rpn_only_loss`` / ``rpn_only_predict``, a ``RetinaHead`` to
``retina_loss`` / ``retina_get_bboxes``, an ``SSDHead`` to
``ssd_loss`` / ``ssd_get_bboxes``, a ``VFNetHead`` to ``vfnet_loss`` /
``vfnet_get_bboxes`` and a ``YOLACTHead`` to
``yolact_loss`` (with the protonet's ``loss_mask_weight``) /
``yolact_predict`` (its boxes; ``yolact_head.yolact_full_predict`` gives
the masks too). ``FastRCNN`` predicts on proposals
passed in (``two_stage.fast_rcnn_predict``), and has no loss, as in the
JAX package. Other detector families and heads are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from dsl_tpu_torch.registry import DETECTORS, MODELS, build_from_cfg
from dsl_tpu_torch.models.dense_heads.fcos_head import (
    FCOSHead, fcos_get_bboxes, fcos_loss)
from dsl_tpu_torch.models.dense_heads.retina_head import (
    RetinaHead, retina_get_bboxes, retina_loss)
from dsl_tpu_torch.models.dense_heads.ssd_head import (
    SSDHead, ssd_get_bboxes, ssd_loss)
from dsl_tpu_torch.models.dense_heads.vfnet_head import (
    VFNetHead, vfnet_get_bboxes, vfnet_loss)
from dsl_tpu_torch.models.dense_heads.yolact_head import (
    YOLACTHead, yolact_loss, yolact_predict)
from dsl_tpu_torch.models.detectors.cascade_rcnn import (
    HTC, CascadeRCNN, SCNet, build_cascade_rcnn, cascade_rcnn_loss,
    cascade_rcnn_predict, htc_loss, htc_predict, scnet_loss, scnet_predict)
from dsl_tpu_torch.models.detectors.two_stage import (
    RPN, FastRCNN, TwoStageDetector, build_two_stage_detector,
    check_two_stage, rpn_only_loss, rpn_only_predict, two_stage_loss,
    two_stage_predict)
from dsl_tpu_torch.models.necks.channel_mapper import build_neck
from dsl_tpu_torch.utils.device import resolve_device
from dsl_tpu_torch.utils.precision import outputs_to_f32, to_compute


@DETECTORS.register
class SingleStageDetector(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module | None,
                 bbox_head: nn.Module, test_cfg: Any = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.test_cfg = test_cfg

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, self.neck, self.bbox_head):
            if part is not None:
                part.init_weights(generator)

    def extract_feat(self, images: torch.Tensor):
        feats = self.backbone(images)
        if self.neck is not None:
            feats = self.neck(feats)
        return feats

    def forward(self, images: torch.Tensor, training: bool = False):
        """images NCHW -> the head's outputs (NHWC per level), in training
        or inference mode."""
        return self.bbox_head(self.extract_feat(images), training=training)


@DETECTORS.register
class FCOS(SingleStageDetector):
    """FCOS = SingleStageDetector with an FCOSHead."""


@DETECTORS.register
class RetinaNet(SingleStageDetector):
    """RetinaNet = SingleStageDetector with a RetinaHead."""


@DETECTORS.register
class SSD(SingleStageDetector):
    """SSD = SingleStageDetector with an SSDHead (no neck in SSD300/512)."""


@DETECTORS.register
class VFNet(SingleStageDetector):
    """VarifocalNet = SingleStageDetector with a VFNetHead."""


@DETECTORS.register
class YOLACT(SingleStageDetector):
    """YOLACT (``mmdet/models/detectors/yolact.py``): the box head with
    mask coefficients, the protonet (``mask_head``, mmdet's name) and the
    segm head, both on the first level."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, segm_head: nn.Module,
                 mask_head: nn.Module, test_cfg: Any = None):
        super().__init__(backbone, neck, bbox_head, test_cfg)
        self.segm_head = segm_head
        self.mask_head = mask_head

    def init_weights(self, generator: torch.Generator | None = None):
        super().init_weights(generator)
        self.segm_head.init_weights(generator)
        self.mask_head.init_weights(generator)

    def forward(self, images: torch.Tensor, training: bool = False):
        """images NCHW -> (cls_scores, bbox_preds, coeff_preds) (NHWC per
        level), prototypes (B, P, 2h, 2w) and segm logits (B, C, h, w), h x
        w the first level's."""
        feats = self.extract_feat(images)
        cls_scores, bbox_preds, coeff_preds = self.bbox_head(
            feats, training=training)
        return (cls_scores, bbox_preds, coeff_preds, self.mask_head(feats[0]),
                self.segm_head(feats[0]))


def build_detector(cfg: dict) -> nn.Module:
    """Build a detector from a model config dict: a config with an
    ``rpn_head`` and ``bbox_heads`` is a cascade (``build_cascade_rcnn``),
    one with an ``rpn_head`` alone a two-stage detector
    (``build_two_stage_detector``), one with ``necks`` or ``bbox_heads``
    and no ``rpn_head`` DSL's co-training multi-head detector
    (``multi_head.build_multi_head_detector``), as in the JAX package; else
    a single-stage one (FCOS and RetinaNet read no ``train_cfg``: their
    assignment options are the head's, as in the JAX package)."""
    cfg = dict(cfg)
    if "rpn_head" in cfg:
        if "bbox_heads" in cfg:
            return build_cascade_rcnn(cfg)
        return build_two_stage_detector(cfg)
    if "bbox_heads" in cfg or "necks" in cfg:
        from dsl_tpu_torch.models.detectors.multi_head import (
            build_multi_head_detector)

        return build_multi_head_detector(cfg)
    det_type = cfg.pop("type")
    det_cls = MODELS.get(det_type)
    if det_cls is None:
        raise KeyError(f"unknown detector type {det_type}")
    backbone = build_from_cfg(dict(cfg.pop("backbone")), MODELS)
    neck_cfg = cfg.pop("neck", None)
    neck = build_neck(neck_cfg, backbone) if neck_cfg else None
    head = build_from_cfg(dict(cfg.pop("bbox_head")), MODELS)
    extra = {}
    if det_type == "YOLACT":
        # the protonet is mmdet's ``mask_head`` (the JAX package's
        # ``proto_head``)
        extra = dict(segm_head=build_from_cfg(dict(cfg.pop("segm_head")),
                                              MODELS),
                     mask_head=build_from_cfg(dict(
                         cfg.pop("mask_head", None) or cfg.pop("proto_head")),
                         MODELS))
    return det_cls(backbone=backbone, neck=neck, bbox_head=head,
                   test_cfg=cfg.get("test_cfg"), **extra)


def empty_detector(cfg: dict) -> nn.Module:
    """:func:`build_detector` with its weights uninitialised (built on the
    meta device, then given CPU storage), for a caller that loads every
    parameter and buffer next: it skips the modules' random init."""
    with torch.device("meta"):
        detector = build_detector(cfg)
    return detector.to_empty(device="cpu")


def _dense_head(detector: nn.Module) -> nn.Module:
    head = getattr(detector, "bbox_head", None)
    if head is None:
        raise NotImplementedError(
            f"{type(detector).__name__}: a multi-head detector has its own "
            f"loss and predict (models/detectors/multi_head.py)")
    if not isinstance(head, (FCOSHead, RetinaHead, SSDHead, YOLACTHead,
                             VFNetHead)):
        raise NotImplementedError(
            f"{type(head).__name__} is not ported yet: only FCOSHead, "
            f"RetinaHead, SSDHead, YOLACTHead and VFNetHead")
    return head


def _parse_losses(losses: dict):
    """Sum every key holding ``loss`` into the total, in f32; return it and
    the log vars (each loss and ``loss``, detached), as 0-d tensors."""
    losses = {k: v.float() for k, v in losses.items()}
    total = sum(v for k, v in losses.items() if "loss" in k)
    log_vars = {k: v.detach() for k, v in losses.items()}
    log_vars["loss"] = total.detach()
    return total, log_vars


def detector_loss(detector: nn.Module, batch: dict, cur_iter: int = 0,
                  compute_dtype=None, mark=None, group=None):
    """Training forward + loss of an FCOS, RetinaNet, SSD, VFNet, Faster
    R-CNN, Cascade R-CNN, HTC, SCNet or standalone RPN detector (a Fast
    R-CNN has no loss, as in the JAX package, and raises).

    ``batch["images"]`` is (B, 3, H, W) on the detector's device; the other
    keys are the head's loss's. With ``compute_dtype=torch.bfloat16`` the
    forward of a single-stage detector runs on bf16 copies of every
    variable (gradients reach the f32 parameters through the casts); the
    head outputs and the losses are f32. A two-stage detector runs
    ``two_stage_loss`` (in f32; a bf16 compute dtype or a process group
    raises), its samplers' draws seeded by ``cur_iter``; a Cascade R-CNN
    runs ``cascade_rcnn_loss``, an HTC ``htc_loss`` and an SCNet
    ``scnet_loss`` under the same refusals. ``mark(name)``,
    where given, is called once the forward is enqueued (``"forward"``),
    for a timing split. ``group`` (a process group, None for one process)
    is the single-stage loss's. The standalone RPN runs ``rpn_only_loss``
    under the two-stage path's refusals. Returns (total, log_vars).
    """
    if isinstance(detector, FastRCNN):
        raise NotImplementedError(
            "FastRCNN has no training loss: the JAX package has none")
    if isinstance(detector, (TwoStageDetector, RPN, CascadeRCNN)):
        check_two_stage(compute_dtype, group)
        loss = (rpn_only_loss if isinstance(detector, RPN)
                else htc_loss if isinstance(detector, HTC)
                else scnet_loss if isinstance(detector, SCNet)
                else cascade_rcnn_loss if isinstance(detector, CascadeRCNN)
                else two_stage_loss)
        return loss(detector, batch, cur_iter=cur_iter, mark=mark)
    head = _dense_head(detector)
    variables, images = to_compute(detector, batch["images"], compute_dtype)
    outputs = outputs_to_f32(functional_call(detector, variables, (images,),
                                             {"training": True}))
    if mark is not None:
        mark("forward")
    if isinstance(head, RetinaHead):
        return _parse_losses(retina_loss(head, *outputs, batch, group=group))
    if isinstance(head, SSDHead):
        return _parse_losses(ssd_loss(head, *outputs, batch, group=group))
    if isinstance(head, VFNetHead):
        return _parse_losses(vfnet_loss(head, *outputs, batch, group=group))
    if isinstance(head, YOLACTHead):
        return _parse_losses(yolact_loss(
            head, outputs, batch, group=group,
            mask_weight=detector.mask_head.loss_mask_weight))
    return _parse_losses(fcos_loss(head, *outputs, batch, cur_iter=cur_iter,
                                   group=group))


def check_predict_device(detector: nn.Module, images: torch.Tensor,
                         device: torch.device):
    """Raise unless the detector and the images lie on ``device``."""
    param_dev = next(detector.parameters()).device
    for what, dev in (("detector", param_dev), ("images", images.device)):
        if dev.type != device.type or (
                dev.type == "cuda" and device.index not in (None, dev.index)):
            raise ValueError(f"predict(device={device}): the {what} "
                             f"lie on {dev}")
    if images.device != param_dev:
        raise ValueError(f"predict: the detector lies on {param_dev}, "
                         f"the images on {images.device}")


@torch.no_grad()
def detector_predict(detector: nn.Module, images: torch.Tensor,
                     img_shapes: torch.Tensor | None = None,
                     scale_factors: torch.Tensor | None = None,
                     test_cfg: dict | None = None, compute_dtype=None,
                     device: str | torch.device = "cuda",
                     params: dict | None = None, with_nms: bool = True):
    """Inference forward + decode + NMS for a batch.

    images (B, 3, H, W) on the detector's device; img_shapes (B, 2) and
    scale_factors (B, 4) optional, as in the JAX package. With
    ``compute_dtype`` every floating variable and the images are cast to it
    for the forward (the module is left as it is); head outputs return to
    f32 before decode. ``params`` (name -> tensor) replaces the detector's
    parameters, e.g. with the EMA teacher's. ``device`` must be where the
    detector and the images lie: CUDA by default, the CPU only when asked
    for. Returns dets (B, max_per_img, 5), labels, valid; with
    ``with_nms=False`` (FCOS only) the decode's candidates instead, as
    ``fcos_get_bboxes`` gives them (boxes, scores, centerness), and the NMS
    kernel is not launched. A two-stage detector runs
    ``two_stage_predict`` (f32 only: a bf16 compute dtype raises), a
    Cascade R-CNN ``cascade_rcnn_predict`` (boxes only, as in the JAX
    package, with or without a mask head; f32 only), an HTC ``htc_predict``
    and an SCNet ``scnet_predict`` (dets, labels, valid and the masks'
    probabilities (B, N, S, S), as in the JAX package; f32 only), the
    standalone RPN ``rpn_only_predict`` (its proposals are the detections,
    all of label 0), a ``RetinaHead`` ``retina_get_bboxes``, an
    ``SSDHead`` ``ssd_get_bboxes``, a ``VFNetHead`` ``vfnet_get_bboxes``
    (its refined boxes) and a ``YOLACTHead`` ``yolact_predict``'s
    boxes (fast NMS: no launch of the NMS kernel; the masks come from
    ``yolact_head.yolact_full_predict``). A Fast R-CNN needs its proposals:
    ``two_stage.fast_rcnn_predict``.
    """
    device = resolve_device(device)
    check_predict_device(detector, images, device)
    if isinstance(detector, FastRCNN):
        raise NotImplementedError("FastRCNN predicts on proposals passed in: "
                                  "two_stage.fast_rcnn_predict")
    if isinstance(detector, RPN):
        check_two_stage(compute_dtype)
        if not with_nms or params is not None:
            raise NotImplementedError("the standalone RPN's predict takes "
                                      "neither with_nms=False nor params")
        return rpn_only_predict(detector, images, img_shapes=img_shapes,
                                scale_factors=scale_factors)
    if isinstance(detector, (TwoStageDetector, CascadeRCNN)):
        check_two_stage(compute_dtype)
        if not with_nms:
            raise NotImplementedError("detector_predict(with_nms=False) "
                                      "gives a dense head's candidates")
        predict = (htc_predict if isinstance(detector, HTC)
                   else scnet_predict if isinstance(detector, SCNet)
                   else cascade_rcnn_predict if isinstance(detector, CascadeRCNN)
                   else two_stage_predict)
        return predict(
            detector, images, img_shapes=img_shapes,
            scale_factors=scale_factors, test_cfg=test_cfg,
            variables=None if params is None else to_compute(
                detector, images, None, params)[0])
    head = _dense_head(detector)
    tc = dict(test_cfg or detector.test_cfg or {})
    nms_cfg = dict(tc.get("nms", {}) or {})
    variables, images = to_compute(detector, images, compute_dtype, params)
    outputs = outputs_to_f32(functional_call(detector, variables, (images,)))
    if isinstance(head, YOLACTHead):
        if not with_nms:
            raise NotImplementedError("detector_predict(with_nms=False) is "
                                      "FCOS's: YOLACT's is not ported yet")
        return yolact_predict(
            head, outputs, img_shapes=img_shapes, scale_factors=scale_factors,
            nms_pre=tc.get("nms_pre", 1000),
            score_thr=tc.get("score_thr", 0.05),
            iou_threshold=nms_cfg.get("iou_threshold", 0.6),
            max_per_img=tc.get("max_per_img", 100),
            img_hw=tuple(images.shape[2:4]))[:3]
    if isinstance(head, (RetinaHead, SSDHead, VFNetHead)):
        if not with_nms:
            raise NotImplementedError(
                f"detector_predict(with_nms=False) is FCOS's: "
                f"{type(head).__name__}'s is not ported yet")
        decode = (retina_get_bboxes if isinstance(head, RetinaHead)
                  else vfnet_get_bboxes if isinstance(head, VFNetHead)
                  else ssd_get_bboxes)
        return decode(
            head, *outputs, img_shapes=img_shapes,
            scale_factors=scale_factors, nms_pre=tc.get("nms_pre", 1000),
            score_thr=tc.get("score_thr", 0.05),
            iou_threshold=nms_cfg.get("iou_threshold", 0.6),
            max_per_img=tc.get("max_per_img", 100))
    cls_scores, bbox_preds, centernesses = outputs
    return fcos_get_bboxes(
        head, cls_scores, bbox_preds, centernesses, img_shapes=img_shapes,
        scale_factors=scale_factors, nms_pre=tc.get("nms_pre", 1000),
        score_thr=tc.get("score_thr", 0.05),
        iou_threshold=nms_cfg.get("iou_threshold", 0.6),
        max_per_img=tc.get("max_per_img", 100), with_nms=with_nms)
