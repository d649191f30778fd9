"""DSL's co-training detector: one backbone feeding N (neck, head) pairs.

Counterpart of ``dsl_tpu/models/detectors/multi_head.py``
(``SingleStageMultiHeadDetector``, ``FCOSMultiHead``,
``build_multi_head_detector``, ``multi_head_loss``,
``multi_head_predict``). The necks and heads are ``nn.ModuleList``s named
``necks.{i}`` and ``bbox_heads.{i}`` (flax's ``necks_{i}`` and
``bbox_heads_{i}``, which ``utils/jax_bridge`` maps). Training sums every
head's DSL FCOS loss; predict decodes every head (one NMS launch each,
inside ``multiclass_nms``), concatenates the detections and merges them
with one class-aware ``batched_nms`` capped at ``max_per_img`` for the
whole batch (one more launch), invalid rows at score -1e30 as in JAX. As
there, the detector has a loss but no train step of its own: a caller
composes ``multi_head_loss``, backward and the optimizer.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from dsl_tpu_torch.core.nms import NEG_INF, batched_nms
from dsl_tpu_torch.models.dense_heads.fcos_head import (
    FCOSHead, fcos_get_bboxes, fcos_loss)
from dsl_tpu_torch.models.detectors.single_stage import (
    _parse_losses, check_predict_device)
from dsl_tpu_torch.registry import DETECTORS, MODELS, build_from_cfg
from dsl_tpu_torch.utils.device import resolve_device
from dsl_tpu_torch.utils.precision import outputs_to_f32, to_compute


@DETECTORS.register
class SingleStageMultiHeadDetector(nn.Module):
    def __init__(self, backbone: nn.Module, necks, bbox_heads,
                 test_cfg: Any = None):
        super().__init__()
        if len(necks) != len(bbox_heads):
            raise ValueError(f"{len(necks)} necks for {len(bbox_heads)} heads")
        self.backbone = backbone
        self.necks = nn.ModuleList(necks)
        self.bbox_heads = nn.ModuleList(bbox_heads)
        self.test_cfg = test_cfg

    @property
    def num_heads(self) -> int:
        return len(self.bbox_heads)

    def init_weights(self, generator: torch.Generator | None = None):
        for part in (self.backbone, *self.necks, *self.bbox_heads):
            part.init_weights(generator)

    def forward(self, images: torch.Tensor, training: bool = False):
        """images NCHW -> one tuple of head outputs (NHWC per level) per
        (neck, head) pair."""
        feats = self.backbone(images)
        return tuple(head(neck(feats), training=training)
                     for neck, head in zip(self.necks, self.bbox_heads))


@DETECTORS.register
class FCOSMultiHead(SingleStageMultiHeadDetector):
    """The FCOS co-training variant."""


def build_multi_head_detector(cfg: dict) -> SingleStageMultiHeadDetector:
    """A multi-head detector from a config with ``necks`` / ``bbox_heads``
    (lists) or the single ``neck`` / ``bbox_head``."""
    cfg = dict(cfg)
    det_type = cfg.pop("type", "FCOSMultiHead")
    det_cls = MODELS.get(det_type)
    if det_cls is None or not issubclass(det_cls, SingleStageMultiHeadDetector):
        raise KeyError(f"{det_type} is not a multi-head detector")
    backbone = build_from_cfg(dict(cfg.pop("backbone")), MODELS)
    neck_cfgs = cfg.pop("necks", None) or [cfg.pop("neck")]
    head_cfgs = cfg.pop("bbox_heads", None) or [cfg.pop("bbox_head")]
    necks = [build_from_cfg(dict(c), MODELS) for c in neck_cfgs]
    heads = [build_from_cfg(dict(c), MODELS) for c in head_cfgs]
    for head in heads:
        if not isinstance(head, FCOSHead):
            raise NotImplementedError(
                f"{type(head).__name__} heads are not ported: only FCOSHead")
    return det_cls(backbone=backbone, necks=necks, bbox_heads=heads,
                   test_cfg=cfg.get("test_cfg"))


def multi_head_loss(detector: SingleStageMultiHeadDetector, batch: dict,
                    cur_iter: int = 0, compute_dtype=None, group=None):
    """Every head's DSL FCOS loss on its own outputs, the keys of head
    ``i > 0`` suffixed ``_h{i}``, summed into the total. ``batch`` is
    ``detector_loss``'s. Returns (total, log_vars), 0-d tensors."""
    variables, images = to_compute(detector, batch["images"], compute_dtype)
    outs = outputs_to_f32(functional_call(detector, variables, (images,),
                                          {"training": True}))
    losses = {}
    for hi, (cls_scores, bbox_preds, cents) in enumerate(outs):
        head_losses = fcos_loss(detector.bbox_heads[hi], cls_scores,
                                bbox_preds, cents, batch, cur_iter=cur_iter,
                                group=group)
        for k, v in head_losses.items():
            losses[f"{k}_h{hi}" if hi else k] = v
    return _parse_losses(losses)


@torch.no_grad()
def multi_head_predict(detector: SingleStageMultiHeadDetector,
                       images: torch.Tensor,
                       img_shapes: torch.Tensor | None = None,
                       scale_factors: torch.Tensor | None = None,
                       test_cfg: dict | None = None, max_per_img: int = 100,
                       compute_dtype=None, device: str | torch.device = "cuda",
                       params: dict | None = None):
    """Decode every head (``fcos_get_bboxes``), concatenate the detections,
    and merge them with one class-aware NMS for the batch, capped at the
    test config's ``max_per_img``. Arguments as ``detector_predict``'s.
    Returns dets (B, max_per_img, 5), labels, valid."""
    device = resolve_device(device)
    check_predict_device(detector, images, device)
    tc = dict(test_cfg or detector.test_cfg or {})
    nms_cfg = dict(tc.get("nms", {}) or {})
    iou = nms_cfg.get("iou_threshold", 0.6)
    max_per_img = tc.get("max_per_img", max_per_img)
    variables, images = to_compute(detector, images, compute_dtype, params)
    outs = outputs_to_f32(functional_call(detector, variables, (images,)))
    decoded = [fcos_get_bboxes(
        detector.bbox_heads[hi], *out, img_shapes=img_shapes,
        scale_factors=scale_factors, nms_pre=tc.get("nms_pre", 1000),
        score_thr=tc.get("score_thr", 0.05), iou_threshold=iou,
        max_per_img=max_per_img) for hi, out in enumerate(outs)]
    dets = torch.cat([d for d, _, _ in decoded], dim=1)       # (B, H*K, 5)
    labels = torch.cat([lab for _, lab, _ in decoded], dim=1)
    valid = torch.cat([v for _, _, v in decoded], dim=1)
    scores = torch.where(valid, dets[..., 4], torch.full_like(dets[..., 4],
                                                              NEG_INF))
    out_dets, _, out_valid, out_labels = batched_nms(
        dets[..., :4], scores, labels, iou_threshold=iou, max_out=max_per_img,
        valid=valid)
    return out_dets, out_labels, out_valid
