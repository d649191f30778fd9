"""Fixed-shape batches in the train step's layout.

Counterpart of ``dsl_tpu/data/formatting.py``. Each sample is placed
top-left on a canvas of one of three static shapes (landscape, portrait,
square) and its GT is K-padded with validity masks. The batch is what
``utils/random_batch.to_torch`` gives, on the images' device:

  images        (B, 3, H, W) f32, right/bottom zero-padded
  gt_bboxes     (B, K, 4) f32   gt_labels (B, K) int64   gt_valid (B, K) bool
  ignore_bboxes (B, Ki, 4) f32  ignore_valid (B, Ki) bool
  img_shapes    (B, 2) f32      scale_factors (B, 4) f32
  source_weight (B,) f32        si_pair {full, half} int64 indices
  meta          list of dicts (host)

and, where the sample has instance masks (``results["gt_masks"]``), as the
JAX package adds them:

  gt_mask_crops (B, K, 112, 112) uint8: each GT's mask cropped to its box
                (floor/ceil, at least a pixel) and resized by OpenCV's
                float ``INTER_LINEAR`` (``mask_head.gt_mask_crop``), >= 0.5
  gt_mask_areas (B, K) f32: each GT's full mask area

built on the images' device.

The scale-invariant copy (the reference's
``semi_epoch_based_runner.py:186-204``) is taken, as in the JAX package,
from the formatted sample: the whole normalized canvas halved bilinearly
(``F.interpolate`` on the device, where the JAX package calls
``cv2.resize``; at an exact half both are the mean of each 2x2 block) and
placed top-left, boxes and ignore boxes halved, ``img_shapes`` halved and
floored, ``scale_factors`` halved.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_CANVAS = (800, 1344)     # Resize(1333, 800) + pad to a multiple of 32
DEFAULT_MAX_GT = 100
DEFAULT_MAX_IGNORE = 60


def select_canvas(shapes, base_hw=DEFAULT_CANVAS) -> tuple[int, int]:
    """Canvas for a batch of (h, w) shapes: (short, long) when all are
    landscape (w >= h), (long, short) when all are portrait, else square."""
    short, long_ = min(base_hw), max(base_hw)
    has_land = any(w >= h for h, w in shapes)
    has_port = any(h > w for h, w in shapes)
    if has_land and has_port:
        return (long_, long_)
    if has_port:
        return (long_, short)
    return (short, long_)


def _pad_boxes(boxes, labels, k: int):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)[:k]
    n = len(boxes)
    out_b = np.zeros((k, 4), np.float32)
    out_b[:n] = boxes
    out_v = np.zeros((k,), bool)
    out_v[:n] = True
    out_l = np.zeros((k,), np.int64)
    if labels is not None:
        out_l[:n] = np.asarray(labels, np.int64).reshape(-1)[:k]
    return out_b, out_l, out_v


def format_sample(results: dict, canvas_hw=DEFAULT_CANVAS,
                  max_gt: int = DEFAULT_MAX_GT,
                  max_ignore: int = DEFAULT_MAX_IGNORE) -> dict:
    """One pipeline output -> the canvas (3, H, W) f32 on the image's device
    and K-padded host arrays (the mask crops and areas on the device)."""
    img = results["img"]
    ch, cw = canvas_hw
    h, w = img.shape[:2]
    if h > ch or w > cw:
        raise ValueError(f"image {h}x{w} exceeds canvas {ch}x{cw}")
    canvas = torch.zeros((3, ch, cw), dtype=torch.float32, device=img.device)
    canvas[:, :h, :w] = img.permute(2, 0, 1)
    gt_b, gt_l, gt_v = _pad_boxes(
        results.get("gt_bboxes", np.zeros((0, 4))),
        results.get("gt_labels", np.zeros((0,))), max_gt)
    ig_b, _, ig_v = _pad_boxes(
        results.get("gt_bboxes_ignore", np.zeros((0, 4))), None, max_ignore)
    sf = np.asarray(results.get("scale_factor", np.ones(4)), np.float32)
    out = dict(
        images=canvas,
        gt_bboxes=gt_b, gt_labels=gt_l, gt_valid=gt_v,
        ignore_bboxes=ig_b, ignore_valid=ig_v,
        img_shapes=np.asarray([h, w], np.float32),
        scale_factors=sf.reshape(4),
        meta=results.get("img_metas", {}))
    if "gt_masks" in results:
        out.update(mask_crops(results["gt_masks"], gt_b, max_gt, img.device))
    return out


def mask_crops(masks, gt_b: np.ndarray, max_gt: int, device) -> dict:
    """``gt_mask_crops`` (K, M, M) uint8 and ``gt_mask_areas`` (K,) f32 on
    ``device`` for the first ``max_gt`` masks (polygons rasterised first),
    each cropped to its padded box ``gt_b``."""
    from dsl_tpu_torch.models.roi_heads.mask_head import (
        GT_MASK_CROP_SIZE, gt_mask_crop)

    if hasattr(masks, "to_bitmap"):
        masks = masks.to_bitmap(device)
    m = GT_MASK_CROP_SIZE
    crops = torch.zeros((max_gt, m, m), dtype=torch.uint8, device=device)
    areas = torch.zeros((max_gt,), dtype=torch.float32, device=device)
    n = min(len(masks), max_gt)
    for i in range(n):
        crops[i] = gt_mask_crop(masks.masks[i], gt_b[i], m) >= 0.5
    if n:
        areas[:n] = masks.masks[:n].sum((1, 2)).to(torch.float32)
    return dict(gt_mask_crops=crops, gt_mask_areas=areas)


def half_res_copy(sample: dict) -> dict:
    """The scale-invariant copy of a formatted sample (see the module's
    docstring)."""
    img = sample["images"]
    ch, cw = img.shape[1:]
    small = F.interpolate(img[None], size=(max(ch // 2, 1), max(cw // 2, 1)),
                          mode="bilinear", align_corners=False)[0]
    canvas = torch.zeros_like(img)
    canvas[:, :small.shape[1], :small.shape[2]] = small
    out = dict(sample)
    out["images"] = canvas
    out["gt_bboxes"] = sample["gt_bboxes"] * 0.5
    out["ignore_bboxes"] = sample["ignore_bboxes"] * 0.5
    out["img_shapes"] = np.floor(sample["img_shapes"] * 0.5)
    out["scale_factors"] = sample["scale_factors"] * 0.5
    return out


def build_batch(samples: list[dict], source_weights=None,
                scale_invariant: bool = False, n_shards: int = 1) -> dict:
    """Stack formatted samples on their device; with ``scale_invariant``
    append the half-res copy of the last one and its ``si_pair``. With
    ``n_shards > 1`` the samples are that many contiguous shards of a
    global batch (as the JAX package shards it over its mesh): each shard
    gets the half-res copy of its own last sample after it, and ``si_pair``
    holds one (full, half) index per shard."""
    sw = [1.0] * len(samples) if source_weights is None else list(source_weights)
    full, half = [], []
    if scale_invariant:
        if len(samples) % n_shards:
            raise ValueError(f"{len(samples)} samples do not split into "
                             f"{n_shards} shards")
        per = len(samples) // n_shards
        grouped, grouped_sw = [], []
        for s in range(n_shards):
            shard, weights = samples[s * per:(s + 1) * per], sw[s * per:(s + 1) * per]
            full.append(len(grouped) + per - 1)
            half.append(len(grouped) + per)
            grouped += shard + [half_res_copy(shard[-1])]
            grouped_sw += weights + [weights[-1]]
        samples, sw = grouped, grouped_sw
    device = samples[0]["images"].device
    batch = {"images": torch.stack([s["images"] for s in samples])}
    for k in samples[0]:
        if k in ("images", "meta"):
            continue
        if torch.is_tensor(samples[0][k]):       # the mask crops and areas
            batch[k] = torch.stack([s[k] for s in samples])
        else:
            batch[k] = torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
    batch["source_weight"] = torch.tensor(sw, dtype=torch.float32, device=device)
    if scale_invariant:
        batch["si_pair"] = {
            "full": torch.tensor(full, dtype=torch.int64, device=device),
            "half": torch.tensor(half, dtype=torch.int64, device=device)}
    batch["meta"] = [s.get("meta", {}) for s in samples]
    return batch
