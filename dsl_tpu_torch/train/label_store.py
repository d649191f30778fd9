"""Pseudo-label store: per-image JSON files, per-class NMS fusion, adaptive
per-class thresholds.

The port's own copy of ``dsl_tpu/train/label_store.py`` (host numpy and
JSON; it writes the same bytes for the same detections):

- per-image ``{name}.json`` with ``imageName/targetNum/rects/tags/masks/
  scores`` (``tools/coco_convert2_semicoco_json.py``), ``json.dump`` with
  ``indent=4, ensure_ascii=False``;
- a refresh write thresholds new teacher detections at
  ``infer_score_thre``, truncates their boxes to integers and rounds scores
  to 6 decimals, optionally concatenates the previous labels
  (``fuse_history``), then runs per-class NMS at ``iou`` with a 0.1 score
  floor;
- ``compute_adathres`` scans all label files and writes per-class
  thresholds ``clip(base * (cum/avg)^gamma1, ranges)`` and class weights
  ``(avg/cum)^gamma2``, counting only boxes above the previous per-class
  threshold.

Each file is written whole or not at all (a temporary file in the same
directory, then ``os.replace``): under data parallelism one rank rewrites
a label file that another rank's loader may read.

:func:`numpy_nms` is greedy NMS in numpy, with the JAX package's semantics
(IoU > thr suppresses, union floored at 1e-10). The JAX package may run the
same loop in its C++ host library; the port has no copy of that library.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np


def _write_json(path: str, obj) -> None:
    """``json.dump(obj, indent=4, ensure_ascii=False)`` into ``path``
    atomically: a reader sees the old file or the new one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=4, ensure_ascii=False)
    os.replace(tmp, path)


def numpy_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
              score_threshold: float = 0.0,
              max_keep: int | None = None) -> np.ndarray:
    """Greedy hard NMS on the host; kept indices in score order, the first
    ``max_keep`` of them where it is given (the greedy pass stops there).
    Each kept box is tested against the boxes after it that are still
    alive, with the IoU the JAX package's loop computes for that pair."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    keep_mask = scores >= score_threshold
    idx_map = np.where(keep_mask)[0]
    order = np.argsort(-scores[keep_mask], kind="mergesort")
    b = boxes[keep_mask][order]
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    alive = np.ones(len(b), bool)
    keep = []
    for pos in range(len(b)):
        if not alive[pos]:
            continue
        keep.append(pos)
        if len(keep) == max_keep:
            break
        rest = pos + 1 + np.flatnonzero(alive[pos + 1:])
        x1 = np.maximum(b[pos, 0], b[rest, 0])
        y1 = np.maximum(b[pos, 1], b[rest, 1])
        x2 = np.minimum(b[pos, 2], b[rest, 2])
        y2 = np.minimum(b[pos, 3], b[rest, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        iou = inter / np.maximum(areas[pos] + areas[rest] - inter, 1e-10)
        alive[rest[iou > iou_threshold]] = False
    return idx_map[order[np.asarray(keep, np.int64)]]


class LabelStore:
    """Directory of per-image pseudo-label JSONs."""

    def __init__(self, root: str, id2cat: dict, cat2id: dict):
        self.root = root
        self.id2cat = {str(k): v for k, v in id2cat.items()}
        self.cat2id = dict(cat2id)
        os.makedirs(root, exist_ok=True)

    def path(self, image_name: str) -> str:
        return osp.join(self.root, image_name + ".json")

    def read(self, image_name: str) -> dict:
        with open(self.path(image_name), "r", encoding="utf-8") as f:
            return json.load(f)

    def write(self, image_name: str, rects, tags, scores,
              image_rel_name: str | None = None):
        data = dict(
            imageName=image_rel_name or ("full/" + image_name),
            targetNum=len(rects),
            rects=[list(map(float, r)) for r in rects],
            tags=list(tags),
            masks=[[] for _ in rects],
            scores=[float(s) for s in scores])
        _write_json(self.path(image_name), data)

    # -- the refresh write (detections -> store) ---------------------------
    def update(self, image_name: str, det_boxes: np.ndarray,
               det_scores: np.ndarray, det_cids: np.ndarray,
               infer_score_thre: float = 0.1, iou: float = 0.6,
               fuse: bool = False, first_ignore: bool = False):
        """Threshold + (optionally) fuse with previous labels via per-class
        NMS, then overwrite the file."""
        keep = det_scores >= infer_score_thre
        # reference parse_det_results (unlabel_pred_hook.py:25-36): new
        # detection boxes are INT-TRUNCATED before storage/fusion, and
        # scores rounded to 6 decimals
        boxes = np.trunc(
            np.asarray(det_boxes, np.float32)[keep].reshape(-1, 4))
        scores = np.round(np.asarray(det_scores, np.float32)[keep]
                          .astype(np.float64), 6).astype(np.float32)
        cids = np.asarray(det_cids, np.int64)[keep]

        if fuse and not first_ignore and osp.exists(self.path(image_name)):
            old = self.read(image_name)
            if old.get("targetNum", 0) > 0:
                old_boxes = np.asarray(old["rects"], np.float32).reshape(-1, 4)
                old_scores = np.asarray(
                    old.get("scores", [1.0] * len(old_boxes)), np.float32)
                old_cids = np.asarray(
                    [self.cat2id[t] for t in old["tags"]], np.int64)
                boxes = np.concatenate([old_boxes, boxes])
                scores = np.concatenate([old_scores, scores])
                cids = np.concatenate([old_cids, cids])

        rects, tags, out_scores = [], [], []
        num_fg = len(self.id2cat) - 1 if "背景" in self.cat2id or \
            "bg" in self.cat2id else len(self.id2cat)
        for c in range(num_fg):
            m = cids == c
            if not m.any():
                continue
            keep_idx = numpy_nms(boxes[m], scores[m], iou, 0.1)
            for k in keep_idx:
                rects.append(boxes[m][k].tolist())
                out_scores.append(float(scores[m][k]))
                tags.append(self.id2cat[str(c)])
        old_name = None
        if osp.exists(self.path(image_name)):
            old_name = self.read(image_name).get("imageName")
        self.write(image_name, rects, tags, out_scores,
                   image_rel_name=old_name)


def compute_adathres(store: LabelStore, image_names: list[str],
                     out_file: str, ranges=(0.3, 0.35), gamma1: float = 0.05,
                     gamma2: float = 0.6, base: float = 0.3) -> dict:
    """Per-class adaptive thresholds + class weights (reference semantics).

    A box counts toward class statistics when its score passes the *previous*
    per-class threshold (or 0.3 when no ``out_file`` yet).
    """
    history = None
    if osp.exists(out_file):
        with open(out_file, "r", encoding="utf-8") as f:
            history = json.load(f).get("thres", {})

    counts: dict[str, int] = {}
    cum: dict[str, float] = {}
    for name in image_names:
        try:
            data = store.read(name)
        except FileNotFoundError:
            continue
        for tag, score in zip(data.get("tags", []),
                              data.get("scores", [1.0] * len(
                                  data.get("tags", [])))):
            if tag not in store.cat2id:
                continue
            prev = 0.3 if history is None else history.get(tag)
            if prev is None:
                pass  # new class: always counts (reference behavior)
            elif score < prev:
                continue
            counts[tag] = counts.get(tag, 0) + 1
            cum[tag] = cum.get(tag, 0.0) + float(score)

    if not counts:
        result = dict(cat={}, id={}, thres={})
        _write_json(out_file, result)
        return result

    avg = sum(counts.values()) / len(counts)
    weights = {t: (avg / cum[t]) ** gamma2 for t in counts}
    thres = {t: max(min((cum[t] / avg) ** gamma1 * base, ranges[1]),
                    ranges[0]) for t in counts}
    result = dict(
        cat={t: weights[t] for t in sorted(weights)},
        id={int(store.cat2id[t]): w for t, w in weights.items()},
        thres=thres)
    _write_json(out_file, result)
    return result
