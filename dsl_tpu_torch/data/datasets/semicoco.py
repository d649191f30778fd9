"""Semi-supervised COCO dataset: GT from per-image JSON files (the label store).

Counterpart of ``dsl_tpu/data/datasets/semicoco.py``:
- the COCO ``ann_file`` supplies only the image list and sizes;
- per-image ground truth lives in ``{ann_path}/{filename}.json``
  (``imageName/targetNum/rects/tags/scores``), read again at every access,
  since the pseudo-label refresh rewrites these files during training;
- ``labelmapper`` maps tag names to contiguous class ids;
- a box whose score is in [lower, upper) becomes an ignore region, one at
  or above ``upper`` GT, one below ``lower`` is dropped; ``upper`` is a
  fixed pair ``thres=[lower, upper]`` or per class from ``adathres.json``
  (default [0.1, 0.3]);
- images under 32 px or with ``targetNum == 0`` are filtered out.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from dsl_tpu_torch.data.datasets.coco import COCO_CLASSES, CocoDataset
from dsl_tpu_torch.registry import DATASETS


@DATASETS.register(name="SemiCOCODataset")
class SemiCOCODataset(CocoDataset):
    CLASSES = COCO_CLASSES

    def __init__(self, ann_file, pipeline, ann_path="", labelmapper="",
                 thres=None, default_thres=(0.1, 0.3), **kwargs):
        self.ann_path = ann_path
        with open(labelmapper, "r", encoding="utf-8") as f:
            self.labelmapper = json.load(f)
        self.thres = thres
        self.default_thres = list(default_thres)
        super().__init__(ann_file=ann_file, pipeline=pipeline, **kwargs)

    # the image list comes from the COCO file (CocoDataset.load_annotations),
    # the GT from the per-image store
    def _store_path(self, filename: str) -> str:
        return osp.join(self.ann_path, filename + ".json")

    def _read_store(self, filename: str) -> dict:
        with open(self._store_path(filename), "r", encoding="utf-8") as f:
            return json.load(f)

    def _upper_thres_for(self, tag: str) -> float:
        """Fixed pair, or live per-class adathres lookup."""
        if self.thres is None:
            return -1.0  # no triage: everything is GT
        if isinstance(self.thres, str):
            if not os.path.exists(self.thres):
                return float(self.default_thres[1])
            with open(self.thres, "r", encoding="utf-8") as f:
                by_class = json.load(f).get("thres", {})
            return float(by_class.get(tag, self.default_thres[1]))
        return float(self.thres[1])

    def _lower_thres(self) -> float:
        if self.thres is None:
            return -1.0
        if isinstance(self.thres, str):
            return float(self.default_thres[0])
        return float(self.thres[0])

    def get_ann_info(self, idx):
        info = self.data_infos[idx]
        data = self._read_store(info["filename"])
        bboxes, labels, ignore = [], [], []
        scores = data.get("scores")
        lower = self._lower_thres()
        for i in range(int(data["targetNum"])):
            x1, y1, x2, y2 = data["rects"][i]
            iw = max(0, min(x2, info["width"]) - max(x1, 0))
            ih = max(0, min(y2, info["height"]) - max(y1, 0))
            if iw * ih == 0 or x2 - x1 < 1 or y2 - y1 < 1:
                continue
            tag = data["tags"][i]
            if scores is not None and self.thres is not None:
                s = float(scores[i])
                upper = self._upper_thres_for(tag)
                if s < lower:
                    continue
                if s < upper:
                    ignore.append([x1, y1, x2, y2])
                    continue
            bboxes.append([x1, y1, x2, y2])
            labels.append(int(self.labelmapper["cat2id"][tag]))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4))

    def _filter_imgs(self, min_size=32):
        valid, valid_ids = [], []
        for i, info in enumerate(self.data_infos):
            if min(info["width"], info["height"]) < min_size:
                continue
            try:
                data = self._read_store(info["filename"])
            except FileNotFoundError:
                continue
            if data.get("targetNum", 0) <= 0:
                continue
            valid.append(i)
            valid_ids.append(self.img_ids[i])
        self.img_ids = valid_ids
        return valid
