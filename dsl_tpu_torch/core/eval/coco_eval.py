"""COCO-protocol bbox and segm evaluation, pure numpy.

Counterpart of ``dsl_tpu/core/eval/coco_eval.py``. The protocol, as
pycocotools computes it:

- 10 IoU thresholds 0.50:0.05:0.95, 101 recall points 0:0.01:1
- area ranges all/small/medium/large, maxDets 100 (plus AR@1/10)
- greedy per-image matching in descending score order: each detection takes
  the unmatched GT with the highest IoU >= thr; crowd GTs are ignore regions
  (IoU computed as intersection-over-detection, matches don't count);
  detections matched to ignore GTs or outside the area range are ignored
- AP = 101-point interpolated precision averaged over recall/classes/IoUs
  (classes with no GT excluded)
- ``segm``: the IoU of masks (``core/masks.mask_iou``; a detection's
  ``segmentation`` is an uncompressed RLE, a GT's an RLE or polygons
  rasterised at the image's size), a detection's area its RLE's
"""

from __future__ import annotations

import numpy as np

from dsl_tpu_torch.core.masks import (
    decode_rle, mask_iou, rasterize_polygons, rle_area)

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)          # 10
REC_THRS = np.round(np.linspace(0.0, 1.0, 101), 2)          # 101
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_xywh(dts: np.ndarray, gts: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """IoU of xywh boxes; crowd gt uses intersection/dt-area (COCO iou)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (dts[:, 2] * dts[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)


class COCOEval:
    """Evaluate COCO-format detections against a COCO index.

    Args:
      coco_gt: ``dsl_tpu_torch.data.coco_api.COCO``
      detections: list of dicts {image_id, category_id, bbox (xywh), score}
      img_ids / cat_ids: evaluation subsets (default: all in gt).
    """

    def __init__(self, coco_gt, detections, iou_type: str = "bbox",
                 img_ids=None, cat_ids=None, max_dets=(1, 10, 100),
                 iou_thrs=None):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        # custom thresholds (e.g. [0.1] for coco_error_analysis); the
        # protocol default is the 0.50:0.95 ladder
        self.iou_thrs = np.asarray(iou_thrs if iou_thrs is not None
                                   else IOU_THRS)
        self.gt = coco_gt
        self.img_ids = list(img_ids if img_ids is not None
                            else coco_gt.get_img_ids())
        self.cat_ids = list(cat_ids if cat_ids is not None
                            else (coco_gt.get_cat_ids() or
                                  sorted({d["category_id"]
                                          for d in detections})))
        self.max_dets = sorted(max_dets)
        self.dts = {}
        img_set = set(self.img_ids)
        for d in detections:
            if d["image_id"] in img_set:
                self.dts.setdefault(
                    (d["image_id"], d["category_id"]), []).append(d)
        self.stats = None

    # -- per (img, cat) matching ------------------------------------------
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = [g for g in self.gt.img_to_anns.get(img_id, [])
               if g["category_id"] == cat_id]
        dts = self.dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        g_boxes = np.asarray([g["bbox"] for g in gts], float).reshape(-1, 4)
        g_crowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gts], bool)
        g_area = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3])
                             for g in gts], float)
        g_ignore = (np.asarray([bool(g.get("ignore", 0)) for g in gts], bool)
                    | g_crowd
                    | (g_area < area_rng[0]) | (g_area > area_rng[1]))

        order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in order][:max_det]
        d_boxes = np.asarray([d["bbox"] for d in dts], float).reshape(-1, 4)
        d_scores = np.asarray([d["score"] for d in dts], float)

        # sort gts: non-ignored first (pycocotools convention)
        g_order = np.argsort(g_ignore, kind="mergesort")
        g_boxes, g_crowd, g_ignore = (g_boxes[g_order], g_crowd[g_order],
                                      g_ignore[g_order])
        if self.iou_type == "segm":
            gts_sorted = [gts[i] for i in g_order]
            ious = self._segm_iou(img_id, dts, gts_sorted, g_crowd)
        else:
            ious = _iou_xywh(d_boxes, g_boxes, g_crowd)

        T = len(self.iou_thrs)
        D, G = len(dts), len(gts)
        dt_m = np.zeros((T, D), dtype=np.int64) - 1    # matched gt index
        gt_m = np.zeros((T, G), dtype=np.int64) - 1
        dt_ig = np.zeros((T, D), bool)
        for ti, thr in enumerate(self.iou_thrs):
            for di in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gt_m[ti, gi] >= 0 and not g_crowd[gi]:
                        continue
                    # stop at ignored gts once a non-ignored match was found
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = g_ignore[best_g]
                dt_m[ti, di] = best_g
                gt_m[ti, best_g] = di
        # unmatched dts outside the area range are ignored
        if self.iou_type == "segm":
            d_area = np.asarray(
                [rle_area(d["segmentation"])
                 if isinstance(d["segmentation"], dict)
                 else d["bbox"][2] * d["bbox"][3] for d in dts], float)
        else:
            d_area = d_boxes[:, 2] * d_boxes[:, 3]
        out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig = dt_ig | ((dt_m == -1) & out_of_rng[None, :])
        return dict(dt_matches=dt_m, dt_ignore=dt_ig, dt_scores=d_scores,
                    gt_ignore=g_ignore, num_gt=int((~g_ignore).sum()))

    def _segm_iou(self, img_id, dts, gts, g_crowd):
        """Mask IoU: a detection's ``segmentation`` is an uncompressed RLE;
        a GT's polygons or an RLE, rasterised at the image's size."""
        info = self.gt.imgs[img_id]
        h, w = info["height"], info["width"]

        def to_mask(seg):
            if isinstance(seg, dict):
                return decode_rle(seg)
            return rasterize_polygons(seg, h, w).numpy()

        d_masks = np.stack([to_mask(d["segmentation"]) for d in dts]) \
            if dts else np.zeros((0, h, w), np.uint8)
        g_masks = np.stack([to_mask(g["segmentation"]) for g in gts]) \
            if gts else np.zeros((0, h, w), np.uint8)
        return mask_iou(d_masks, g_masks, g_crowd)

    # -- accumulate --------------------------------------------------------
    def evaluate(self):
        T, R = len(self.iou_thrs), len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RNG)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        area_items = list(AREA_RNG.items())
        for ki, cat_id in enumerate(self.cat_ids):
            for ai, (_, rng) in enumerate(area_items):
                for mi, max_det in enumerate(self.max_dets):
                    evals = [self._evaluate_img(i, cat_id, rng, max_det)
                             for i in self.img_ids]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["dt_scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dt_m = np.concatenate(
                        [e["dt_matches"] for e in evals], axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ignore"] for e in evals], axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    tps = (dt_m >= 0) & ~dt_ig
                    fps = (dt_m == -1) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone non-increasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.precision = precision
        self.recall = recall

        def _ap(iou_thr=None, area="all", max_det=None):
            ai = list(AREA_RNG).index(area)
            mi = self.max_dets.index(max_det) if max_det is not None \
                else len(self.max_dets) - 1
            p = precision[:, :, :, ai, mi]
            if iou_thr is not None:
                where = np.where(np.isclose(self.iou_thrs,
                                                iou_thr))[0]
                if where.size == 0:      # threshold not in this ladder
                    return -1.0
                ti = int(where[0])
                p = p[ti:ti + 1]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def _ar(area="all", max_det=None):
            ai = list(AREA_RNG).index(area)
            mi = self.max_dets.index(max_det) if max_det is not None \
                else len(self.max_dets) - 1
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        self.stats = dict(
            mAP=_ap(), mAP_50=_ap(0.5), mAP_75=_ap(0.75),
            mAP_s=_ap(area="small"), mAP_m=_ap(area="medium"),
            mAP_l=_ap(area="large"),
            AR_1=_ar(max_det=self.max_dets[0]) if len(self.max_dets) > 1
            else -1,
            AR_10=_ar(max_det=self.max_dets[1]) if len(self.max_dets) > 2
            else -1,
            AR_100=_ar(), AR_s=_ar(area="small"), AR_m=_ar(area="medium"),
            AR_l=_ar(area="large"))
        return self.stats

    def summarize(self):
        s = self.stats or self.evaluate()
        rows = [
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all ]",
             s["mAP"]),
            ("Average Precision  (AP) @[ IoU=0.50      | area=   all ]",
             s["mAP_50"]),
            ("Average Precision  (AP) @[ IoU=0.75      | area=   all ]",
             s["mAP_75"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small ]",
             s["mAP_s"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium ]",
             s["mAP_m"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large ]",
             s["mAP_l"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all ]",
             s["AR_100"]),
        ]
        for name, val in rows:
            print(f"{name} = {val:.3f}")
        return s
