"""Box math of the predict and train paths, in torch.

Counterpart of ``dsl_tpu/core/boxes.py``: boxes are ``(x1, y1, x2, y2)``,
corner-exclusive (area = (x2-x1)*(y2-y1)), and every function is
shape-polymorphic over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6


def _floor(x: torch.Tensor, value: float) -> torch.Tensor:
    """max(x, value) as ``jnp.maximum`` computes it: at a tie the gradient
    splits 0.5/0.5, where ``clamp_min`` passes all of it (boxes with integer
    corners touch exactly). The constant is made on x's device, no copy."""
    return torch.maximum(x, x.new_full((), value))


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) boxes."""
    w = _floor(boxes[..., 2] - boxes[..., 0], 0.0)
    h = _floor(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  mode: str = "iou", is_aligned: bool = False,
                  eps: float = EPS) -> torch.Tensor:
    """IoU or GIoU, pairwise (..., M, 4) x (..., N, 4) -> (..., M, N), or
    aligned (..., M, 4) x (..., M, 4) -> (..., M)."""
    if mode not in ("iou", "giou"):
        raise ValueError(f"bbox_overlaps mode {mode!r}: 'iou' or 'giou'")
    area1 = bbox_area(boxes1)
    area2 = bbox_area(boxes2)
    if not is_aligned:
        boxes1, boxes2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = _floor(rb - lt, 0.0)
    overlap = wh[..., 0] * wh[..., 1]
    union = _floor(area1 + area2 - overlap, eps)
    ious = overlap / union
    if mode == "iou":
        return ious
    enc_lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    enc_rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    enc_wh = _floor(enc_rb - enc_lt, 0.0)
    enc_area = _floor(enc_wh[..., 0] * enc_wh[..., 1], eps)
    return ious - (enc_area - union) / enc_area


def clip_boxes(boxes: torch.Tensor, max_shape: tuple[int, int]) -> torch.Tensor:
    """Clip boxes to an image of (H, W)."""
    h, w = max_shape[0], max_shape[1]
    x1 = boxes[..., 0].clamp(0, w)
    y1 = boxes[..., 1].clamp(0, h)
    x2 = boxes[..., 2].clamp(0, w)
    y2 = boxes[..., 3].clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2bbox(points: torch.Tensor, distances: torch.Tensor,
                  max_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Decode (l, t, r, b) distances at (x, y) points into boxes."""
    x1 = points[..., 0] - distances[..., 0]
    y1 = points[..., 1] - distances[..., 1]
    x2 = points[..., 0] + distances[..., 2]
    y2 = points[..., 1] + distances[..., 3]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor,
                  max_dis: float | None = None, eps: float = 0.1) -> torch.Tensor:
    """Encode boxes as (l, t, r, b) distances from (x, y) points."""
    d = torch.stack([points[..., 0] - bbox[..., 0],
                     points[..., 1] - bbox[..., 1],
                     bbox[..., 2] - points[..., 0],
                     bbox[..., 3] - points[..., 1]], dim=-1)
    if max_dis is not None:
        d = d.clamp(0, max_dis - eps)
    return d


def _affine(d: torch.Tensor, scale, shift, inverse: bool = False):
    """Each of the last axis's 4 components times ``scale[i]`` plus
    ``shift[i]`` (or ``(d - shift[i]) / scale[i]`` with ``inverse``), the
    constants as f32 scalars, as the JAX package's f32 arrays apply them
    (python scalars, so no host-to-device copy)."""
    parts = [(d[..., i] - shift[i]) / scale[i] if inverse
             else d[..., i] * scale[i] + shift[i] for i in range(4)]
    return torch.stack(parts, dim=-1)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode gt boxes relative to proposals as (dx, dy, dw, dh) deltas
    (``DeltaXYWHBBoxCoder.encode``)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    dx = (gx - px) / _floor(pw, EPS)
    dy = (gy - py) / _floor(ph, EPS)
    dw = torch.log(_floor(gw, EPS) / _floor(pw, EPS))
    dh = torch.log(_floor(gh, EPS) / _floor(ph, EPS))
    return _affine(torch.stack([dx, dy, dw, dh], dim=-1), stds, means,
                   inverse=True)


def _max_ratio(wh_ratio_clip: float) -> float:
    """|log(wh_ratio_clip)| in f32, as the JAX package computes it."""
    return float(np.abs(np.log(np.float32(wh_ratio_clip))))


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
               max_shape: tuple[int, int] | None = None,
               wh_ratio_clip: float = 16.0 / 1000.0) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on rois into boxes
    (``DeltaXYWHBBoxCoder.decode``): dw and dh clamped to
    +-|log(wh_ratio_clip)|, the boxes clipped to ``max_shape`` (H, W)
    where given. YOLOF's ``add_ctr_clamp`` is not ported yet."""
    d = _affine(deltas, stds, means)
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    max_ratio = _max_ratio(wh_ratio_clip)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                         gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes


def legacy_bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
                      means=(0.0, 0.0, 0.0, 0.0),
                      stds=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """MMDet V1.x delta encoding (``LegacyDeltaXYWHBBoxCoder``): widths
    and heights with the +1 pixel convention."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    return _affine(deltas, stds, means, inverse=True)


def legacy_delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
                      means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
                      max_shape: tuple[int, int] | None = None,
                      wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """MMDet V1.x delta decoding: the +1 width convention, the corners
    without the true-legacy 0.5 shift (as the reference coder), clipped to
    ``max_shape - 1``. ``deltas`` may hold several boxes per roi on its
    last axis (4k)."""
    k = deltas.shape[-1] // 4
    d = _affine(deltas.reshape(*deltas.shape[:-1], k, 4), stds, means)
    max_ratio = _max_ratio(wh_ratio_clip)
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                       gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        out = torch.stack([out[..., 0].clamp(0, max_shape[1] - 1),
                           out[..., 1].clamp(0, max_shape[0] - 1),
                           out[..., 2].clamp(0, max_shape[1] - 1),
                           out[..., 3].clamp(0, max_shape[0] - 1)], dim=-1)
    return out.reshape(deltas.shape)


def resolve_delta_coder(cfg, default_means=(0.0, 0.0, 0.0, 0.0),
                        default_stds=(1.0, 1.0, 1.0, 1.0)):
    """A ``bbox_coder`` config -> ``(encode, decode, means, stds)``: the
    stock ``DeltaXYWHBBoxCoder`` (the default) or the V1.x
    ``LegacyDeltaXYWHBBoxCoder``; another type raises. The config's
    ``target_means`` / ``target_stds`` win over the head's defaults."""
    c = dict(cfg or {})
    t = c.get("type", "DeltaXYWHBBoxCoder")
    means = tuple(c.get("target_means", default_means))
    stds = tuple(c.get("target_stds", default_stds))
    if t == "DeltaXYWHBBoxCoder":
        return bbox2delta, delta2bbox, means, stds
    if t == "LegacyDeltaXYWHBBoxCoder":
        return legacy_bbox2delta, legacy_delta2bbox, means, stds
    raise ValueError(f"unsupported delta bbox_coder type: {t}")


def clip_to_shapes(boxes: torch.Tensor, img_shapes: torch.Tensor) -> torch.Tensor:
    """(B, ..., 4) boxes clipped to each image's (H, W) in ``img_shapes``
    (B, 2), as the JAX heads clip their decoded boxes."""
    lead = (slice(None),) + (None,) * (boxes.dim() - 2)
    xlim = img_shapes[lead + (1,)]
    ylim = img_shapes[lead + (0,)]
    zero = boxes.new_zeros(())
    return torch.stack([torch.minimum(torch.maximum(boxes[..., 0], zero), xlim),
                        torch.minimum(torch.maximum(boxes[..., 1], zero), ylim),
                        torch.minimum(torch.maximum(boxes[..., 2], zero), xlim),
                        torch.minimum(torch.maximum(boxes[..., 3], zero), ylim)],
                       dim=-1)
