"""VOC-protocol mAP and proposal recall, pure numpy, on the host.

The port's copy of ``dsl_tpu/core/eval/mean_ap.py`` (``average_precision``
with ``'area'`` and ``'11points'``, ``tpfp_default``, ``tpfp_imagenet``,
``_get_cls_results``, ``eval_map``, ``eval_recalls``), with the semantics
the JAX package pins against mmdet's own code:

- a detection's argmax-IoU gt is taken over the concatenated
  ``[gt, gt_ignore]`` stack; where the best match is an ignore box the
  detection is neither TP nor FP, even when it also overlaps a real gt
  above the threshold;
- a second detection on an already covered gt is a FP;
- ``labels_ignore`` absent means no ignore box for any class;
- ``scale_ranges`` (side lengths): gts and detections outside an area
  range are ignored, one AP per range;
- recall matching is greedy and one-to-one (a proposal satisfies one gt).
"""

from __future__ import annotations

import numpy as np


def _iou_xyxy(dts: np.ndarray, gts: np.ndarray) -> np.ndarray:
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    ix1 = np.maximum(dts[:, None, 0], gts[None, :, 0])
    iy1 = np.maximum(dts[:, None, 1], gts[None, :, 1])
    ix2 = np.minimum(dts[:, None, 2], gts[None, :, 2])
    iy2 = np.minimum(dts[:, None, 3], gts[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    a1 = ((dts[:, 2] - dts[:, 0]) * (dts[:, 3] - dts[:, 1]))[:, None]
    a2 = ((gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]))[None, :]
    return inter / np.maximum(a1 + a2 - inter, np.finfo(np.float32).eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area"):
    """AP for single or multiple scales (mmdet ``average_precision``).

    recalls/precisions: (num_dets,) or (num_scales, num_dets).
    Returns float (1-D inputs) or (num_scales,) ndarray.
    """
    no_scale = False
    if recalls.ndim == 1:
        no_scale = True
        recalls = recalls[None, :]
        precisions = precisions[None, :]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind])
                           * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0.0
        ap /= 11
    else:
        raise ValueError(mode)
    return float(ap[0]) if no_scale else ap


def tpfp_default(det: np.ndarray, gt: np.ndarray, gt_ignore: np.ndarray,
                 iou_thr: float = 0.5, area_ranges=None):
    """TP/FP flags for one image's class detections (mmdet
    ``tpfp_default``). Returns (num_scales, num_dets) tp and fp arrays."""
    gt_ignore_inds = np.concatenate(
        (np.zeros(len(gt), bool), np.ones(len(gt_ignore), bool)))
    gt_all = np.vstack((gt.reshape(-1, 4), gt_ignore.reshape(-1, 4)))
    nd, ng = len(det), len(gt_all)
    if area_ranges is None:
        area_ranges = [(None, None)]
    ns = len(area_ranges)
    tp = np.zeros((ns, nd), np.float32)
    fp = np.zeros((ns, nd), np.float32)
    if ng == 0:
        if area_ranges == [(None, None)]:
            fp[...] = 1
        else:
            det_areas = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            for i, (mn, mx) in enumerate(area_ranges):
                fp[i, (det_areas >= mn) & (det_areas < mx)] = 1
        return tp, fp
    ious = _iou_xyxy(det[:, :4], gt_all)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det[:, -1])
    for k, (mn, mx) in enumerate(area_ranges):
        gt_covered = np.zeros(ng, bool)
        if mn is None:
            gt_area_ignore = np.zeros(ng, bool)
        else:
            gt_areas = (gt_all[:, 2] - gt_all[:, 0]) \
                * (gt_all[:, 3] - gt_all[:, 1])
            gt_area_ignore = (gt_areas < mn) | (gt_areas >= mx)
        for i in sort_inds:
            if ious_max[i] >= iou_thr:
                j = ious_argmax[i]
                if not (gt_ignore_inds[j] or gt_area_ignore[j]):
                    if not gt_covered[j]:
                        gt_covered[j] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # else: matched an ignored gt — neither tp nor fp
            elif mn is None:
                fp[k, i] = 1
            else:
                b = det[i, :4]
                area = (b[2] - b[0]) * (b[3] - b[1])
                if mn <= area < mx:
                    fp[k, i] = 1
    return tp, fp


def tpfp_imagenet(det: np.ndarray, gt: np.ndarray, gt_ignore: np.ndarray,
                  default_iou_thr: float = 0.5, area_ranges=None):
    """ImageNet-DET TP/FP (mmdet ``tpfp_imagenet``): per-gt adaptive
    IoU threshold min(wh/((w+10)(h+10)), thr), IoU against gt−1, and a
    det may claim the best still-uncovered gt (unlike VOC)."""
    gt_ignore_inds = np.concatenate(
        (np.zeros(len(gt), bool), np.ones(len(gt_ignore), bool)))
    gt_all = np.vstack((gt.reshape(-1, 4), gt_ignore.reshape(-1, 4)))
    nd, ng = len(det), len(gt_all)
    if area_ranges is None:
        area_ranges = [(None, None)]
    ns = len(area_ranges)
    tp = np.zeros((ns, nd), np.float32)
    fp = np.zeros((ns, nd), np.float32)
    if ng == 0:
        if area_ranges == [(None, None)]:
            fp[...] = 1
        else:
            det_areas = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            for i, (mn, mx) in enumerate(area_ranges):
                fp[i, (det_areas >= mn) & (det_areas < mx)] = 1
        return tp, fp
    ious = _iou_xyxy(det[:, :4], gt_all - 1)
    gt_w = gt_all[:, 2] - gt_all[:, 0]
    gt_h = gt_all[:, 3] - gt_all[:, 1]
    iou_thrs = np.minimum((gt_w * gt_h) / ((gt_w + 10.0) * (gt_h + 10.0)),
                          default_iou_thr)
    sort_inds = np.argsort(-det[:, -1])
    for k, (mn, mx) in enumerate(area_ranges):
        gt_covered = np.zeros(ng, bool)
        if mn is None:
            gt_area_ignore = np.zeros(ng, bool)
        else:
            gt_areas = gt_w * gt_h
            gt_area_ignore = (gt_areas < mn) | (gt_areas >= mx)
        for i in sort_inds:
            max_iou, matched = -1.0, -1
            for j in range(ng):
                if gt_covered[j]:
                    continue
                if ious[i, j] >= iou_thrs[j] and ious[i, j] > max_iou:
                    max_iou = ious[i, j]
                    matched = j
            if matched >= 0:
                gt_covered[matched] = True
                if not (gt_ignore_inds[matched] or gt_area_ignore[matched]):
                    tp[k, i] = 1
            elif mn is None:
                fp[k, i] = 1
            else:
                b = det[i, :4]
                area = (b[2] - b[0]) * (b[3] - b[1])
                if mn <= area < mx:
                    fp[k, i] = 1
    return tp, fp


def _get_cls_results(det_results, annotations, class_id):
    """mmdet's ``get_cls_results``; note ``labels_ignore`` absent
    means NO ignore boxes for any class."""
    cls_dets = [np.asarray(r[class_id], np.float32).reshape(-1, 5)
                for r in det_results]
    cls_gts, cls_ig = [], []
    for ann in annotations:
        labels = np.asarray(ann["labels"]).reshape(-1)
        boxes = np.asarray(ann["bboxes"], np.float32).reshape(-1, 4)
        cls_gts.append(boxes[labels == class_id])
        if ann.get("labels_ignore", None) is not None:
            ig_l = np.asarray(ann["labels_ignore"]).reshape(-1)
            ig_b = np.asarray(ann["bboxes_ignore"],
                              np.float32).reshape(-1, 4)
            cls_ig.append(ig_b[ig_l == class_id])
        else:
            cls_ig.append(np.empty((0, 4), np.float32))
    return cls_dets, cls_gts, cls_ig


def eval_map(det_results: list, annotations: list, scale_ranges=None,
             iou_thr: float = 0.5, mode: str | None = None,
             dataset: str | None = None, verbose: bool = False):
    """Compute VOC mAP (mmdet ``eval_map``).

    Args:
      det_results: per image, list of C arrays (n_i, 5) [x1,y1,x2,y2,score].
      annotations: per image dicts with ``bboxes`` (n, 4), ``labels`` (n,),
        optional ``bboxes_ignore``/``labels_ignore``.
      scale_ranges: [(min1, max1), ...] in SIDE lengths (areas = side**2).
      mode: 'area'/'11points'; default 'area' ('11points' when
        ``dataset == 'voc07'`` — mmdet's rule).

    Returns (mAP, per-class results list). With scale_ranges, mAP is a list
    per scale and per-class num_gts/ap are per-scale arrays.
    """
    assert len(det_results) == len(annotations)
    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    num_classes = len(det_results[0])
    area_ranges = ([(rg[0] ** 2, rg[1] ** 2) for rg in scale_ranges]
                   if scale_ranges is not None else None)
    if mode is None:
        mode = "11points" if dataset == "voc07" else "area"

    tpfp_fn = tpfp_imagenet if dataset in ("det", "vid") else tpfp_default
    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_ig = _get_cls_results(
            det_results, annotations, c)
        tpfp = [tpfp_fn(d, g, ig, iou_thr, area_ranges)
                for d, g, ig in zip(cls_dets, cls_gts, cls_ig)]
        tp, fp = tuple(zip(*tpfp))
        num_gts = np.zeros(num_scales, int)
        for bbox in cls_gts:
            if area_ranges is None:
                num_gts[0] += bbox.shape[0]
            else:
                gt_areas = (bbox[:, 2] - bbox[:, 0]) \
                    * (bbox[:, 3] - bbox[:, 1])
                for k, (mn, mx) in enumerate(area_ranges):
                    num_gts[k] += int(((gt_areas >= mn)
                                       & (gt_areas < mx)).sum())
        all_dets = np.vstack(cls_dets)
        num_dets = all_dets.shape[0]
        sort_inds = np.argsort(-all_dets[:, -1])
        tp = np.cumsum(np.hstack(tp)[:, sort_inds], axis=1)
        fp = np.cumsum(np.hstack(fp)[:, sort_inds], axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        if scale_ranges is None:
            recalls = recalls[0, :]
            precisions = precisions[0, :]
            num_gts = num_gts.item()
        ap = average_precision(recalls, precisions, mode)
        eval_results.append(dict(
            num_gts=num_gts, num_dets=num_dets, ap=ap,
            recall=recalls, precision=precisions))
    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in eval_results])
        all_ng = np.vstack([r["num_gts"] for r in eval_results])
        mean_ap = []
        for i in range(num_scales):
            if np.any(all_ng[:, i] > 0):
                mean_ap.append(float(all_ap[all_ng[:, i] > 0, i].mean()))
            else:
                mean_ap.append(0.0)
    else:
        aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0
    if verbose:
        for c, r in enumerate(eval_results):
            rec = r["recall"]
            last = float(np.atleast_2d(rec)[0, -1]) if np.size(rec) else 0.0
            print(f"class {c}: gts={r['num_gts']} dets={r['num_dets']} "
                  f"recall={last:.3f} ap={np.round(r['ap'], 3)}")
        print(f"mAP@{iou_thr}: {mean_ap}")
    return mean_ap, eval_results


def eval_recalls(gts: list, proposals: list, proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,)):
    """Proposal recall matrix (mmdet ``recall.py eval_recalls``):
    proposals sorted by score when (k, 5), greedy ONE-TO-ONE gt↔proposal
    matching (each proposal may satisfy only one gt)."""
    proposal_nums = np.atleast_1d(np.asarray(proposal_nums))
    iou_thrs = np.atleast_1d(np.asarray(iou_thrs, float))
    all_ious = []
    for gt, prop in zip(gts, proposals):
        p = np.asarray(prop, np.float32)
        if p.ndim == 2 and p.shape[1] == 5:
            p = p[np.argsort(p[:, 4])[::-1]]
        pn = min(p.shape[0], int(proposal_nums[-1]))
        g = np.asarray(gt, np.float32).reshape(-1, 4) if gt is not None \
            else np.zeros((0, 4), np.float32)
        if len(g) == 0:
            all_ious.append(np.zeros((0, p.shape[0]), np.float32))
        else:
            all_ious.append(_iou_xyxy(g, p[:pn, :4]))
    total_gt = sum(i.shape[0] for i in all_ious)
    recalls = np.zeros((proposal_nums.size, iou_thrs.size))
    if total_gt == 0:
        return recalls
    best = np.zeros((proposal_nums.size, total_gt), np.float32)
    for k, pn in enumerate(proposal_nums):
        pos = 0
        for ious0 in all_ious:
            ng = ious0.shape[0]
            ious = ious0[:, :int(pn)].copy()
            if ious.size:
                for j in range(ng):
                    # j-th best remaining (gt, proposal) pair; slots are
                    # sequential (mmdet _recalls), not per-gt
                    gt_max = ious.argmax(axis=1)
                    max_ious = ious[np.arange(ng), gt_max]
                    gi = max_ious.argmax()
                    best[k, pos + j] = max_ious[gi]
                    ious[gi, :] = -1
                    ious[:, gt_max[gi]] = -1
            pos += ng
    for i, thr in enumerate(iou_thrs):
        recalls[:, i] = (best >= thr).sum(axis=1) / float(total_gt)
    return recalls
