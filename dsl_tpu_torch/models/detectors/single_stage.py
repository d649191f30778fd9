"""Single-stage detector (FCOS), its builder and its predict function.

Counterpart of the single-stage branch of
``dsl_tpu/models/detectors/single_stage.py``: ``SingleStageDetector`` /
``FCOS`` (backbone -> neck -> head), ``build_detector`` for single-stage
configs, and the FCOS branch of ``detector_predict``. Other detector
families are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from dsl_tpu_torch.registry import DETECTORS, MODELS, build_from_cfg
from dsl_tpu_torch.models.dense_heads.fcos_head import FCOSHead, fcos_get_bboxes
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

    def forward(self, images: torch.Tensor):
        """images NCHW -> the head's inference outputs (NHWC per level)."""
        return self.bbox_head(self.extract_feat(images))


@DETECTORS.register
class FCOS(SingleStageDetector):
    """FCOS = SingleStageDetector with an FCOSHead."""


def build_detector(cfg: dict) -> nn.Module:
    """Build a single-stage detector from a model config dict (its
    ``train_cfg`` is for training, which is not ported yet)."""
    cfg = dict(cfg)
    if "rpn_head" in cfg or "bbox_heads" in cfg or "necks" in cfg:
        raise NotImplementedError("only single-stage detectors are ported yet")
    det_type = cfg.pop("type")
    det_cls = MODELS.get(det_type)
    if det_cls is None:
        raise KeyError(f"unknown detector type {det_type}")
    backbone = build_from_cfg(dict(cfg.pop("backbone")), MODELS)
    neck_cfg = cfg.pop("neck", None)
    if isinstance(neck_cfg, (list, tuple)):
        raise NotImplementedError("stacked necks are not ported yet")
    neck = build_from_cfg(dict(neck_cfg), MODELS) if neck_cfg else None
    head = build_from_cfg(dict(cfg.pop("bbox_head")), MODELS)
    return det_cls(backbone=backbone, neck=neck, bbox_head=head,
                   test_cfg=cfg.get("test_cfg"))


@torch.no_grad()
def detector_predict(detector: nn.Module, images: torch.Tensor,
                     img_shapes: torch.Tensor | None = None,
                     scale_factors: torch.Tensor | None = None,
                     test_cfg: dict | None = None, compute_dtype=None,
                     device: str | torch.device = "cuda"):
    """Inference forward + decode + NMS for a batch.

    images (B, 3, H, W) on the detector's device; img_shapes (B, 2) and
    scale_factors (B, 4) optional, as in the JAX package. With
    ``compute_dtype`` every floating variable and the images are cast to it
    for the forward (the module is left as it is); head outputs return to
    f32 before decode. ``device`` must be where the detector and the images
    lie: CUDA by default, the CPU only when asked for. Returns dets
    (B, max_per_img, 5), labels, valid.
    """
    device = resolve_device(device)
    param_dev = next(detector.parameters()).device
    for what, dev in (("detector", param_dev), ("images", images.device)):
        if dev.type != device.type or (
                dev.type == "cuda" and device.index not in (None, dev.index)):
            raise ValueError(f"detector_predict(device={device}): the {what} "
                             f"lie on {dev}")
    if images.device != param_dev:
        raise ValueError(f"detector_predict: the detector lies on {param_dev}, "
                         f"the images on {images.device}")
    head = detector.bbox_head
    if not isinstance(head, FCOSHead):
        raise NotImplementedError(
            f"predict for {type(head).__name__} is not ported yet")
    tc = dict(test_cfg or detector.test_cfg or {})
    nms_cfg = dict(tc.get("nms", {}) or {})
    variables, images = to_compute(detector, images, compute_dtype)
    outputs = outputs_to_f32(functional_call(detector, variables, (images,)))
    cls_scores, bbox_preds, centernesses = outputs
    return fcos_get_bboxes(
        head, cls_scores, bbox_preds, centernesses, img_shapes=img_shapes,
        scale_factors=scale_factors, nms_pre=tc.get("nms_pre", 1000),
        score_thr=tc.get("score_thr", 0.05),
        iou_threshold=nms_cfg.get("iou_threshold", 0.6),
        max_per_img=tc.get("max_per_img", 100))
