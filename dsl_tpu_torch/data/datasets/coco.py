"""COCO dataset (one annotation file).

Counterpart of ``dsl_tpu/data/datasets/coco.py``: category ids remapped to
contiguous labels, xywh -> xyxy, ``iscrowd`` -> ignore boxes, empty and
small images filtered, each kept annotation's ``segmentation`` kept as its
mask; detections exported as COCO json and evaluated by the COCO protocol
(``core/eval/coco_eval.py``) for ``bbox`` and ``segm``. A mask result is
(dets, labels, masks), each mask an (H, W) binary array at the original
size (encoded here, ``core/masks.encode_rle``) or already its
uncompressed RLE (what ``apis/test.py`` gives, having encoded each batch's
masks before the next).
"""

from __future__ import annotations

import numpy as np

from dsl_tpu_torch.core.masks import encode_rle
from dsl_tpu_torch.data.coco_api import COCO
from dsl_tpu_torch.data.datasets.custom import CustomDataset
from dsl_tpu_torch.registry import DATASETS

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag',
    'tie', 'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
    'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush')


@DATASETS.register(name="CocoDataset")
class CocoDataset(CustomDataset):
    CLASSES = COCO_CLASSES

    def load_annotations(self, ann_file):
        self.coco = COCO(ann_file)
        # keep the declared class order where the file has those names
        try:
            self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES)
        except KeyError:
            self.cat_ids = sorted(self.coco.cats.keys())
        if not self.cat_ids:
            self.cat_ids = list(range(len(self.CLASSES)))
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        data_infos = []
        for i in self.img_ids:
            info = dict(self.coco.load_imgs([i])[0])
            info["filename"] = info.get("file_name", info.get("filename"))
            data_infos.append(info)
        return data_infos

    def get_ann_info(self, idx):
        img_id = self.data_infos[idx]["id"]
        anns = self.coco.img_to_anns.get(img_id, [])
        return self._parse_ann_info(self.data_infos[idx], anns)

    def _parse_ann_info(self, img_info, anns):
        bboxes, labels, ignore, masks = [], [], [], []
        for a in anns:
            if a.get("ignore", False):
                continue
            x, y, w, h = a["bbox"]
            iw = max(0, min(x + w, img_info["width"]) - max(x, 0))
            ih = max(0, min(y + h, img_info["height"]) - max(y, 0))
            if iw * ih == 0 or a.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if a["category_id"] not in self.cat2label:
                continue
            box = [x, y, x + w, y + h]
            if a.get("iscrowd", False):
                ignore.append(box)
            else:
                bboxes.append(box)
                labels.append(self.cat2label[a["category_id"]])
                masks.append(a.get("segmentation", None))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
            masks=masks)

    def _filter_imgs(self, min_size=32):
        valid = []
        for i, info in enumerate(self.data_infos):
            if min(info["width"], info["height"]) < min_size:
                continue
            if self.filter_empty_gt and not self.coco.img_to_anns.get(
                    info["id"]):
                continue
            valid.append(i)
        self.img_ids = [self.data_infos[i]["id"] for i in valid]
        return valid

    def results2json_bbox(self, results):
        """``results``: per image (dets (N, 5), labels (N,)) host arrays.
        Returns COCO-format detection dicts (xywh)."""
        out = []
        for idx, (dets, labels) in enumerate(results):
            img_id = self.data_infos[idx]["id"]
            for det, label in zip(dets, labels):
                x1, y1, x2, y2, score = det
                out.append(dict(
                    image_id=img_id,
                    bbox=[float(x1), float(y1), float(x2 - x1),
                          float(y2 - y1)],
                    score=float(score),
                    category_id=int(self.cat_ids[int(label)])))
        return out

    def results2json_segm(self, results):
        """``results``: per image (dets (N, 5), labels (N,), masks: (N, H, W)
        binary at the original size, or N uncompressed RLEs). Returns COCO
        segm dicts with an uncompressed-RLE ``segmentation``."""
        out = []
        for idx, (dets, labels, masks) in enumerate(results):
            img_id = self.data_infos[idx]["id"]
            for det, label, mask in zip(dets, labels, masks):
                x1, y1, x2, y2, score = det
                out.append(dict(
                    image_id=img_id,
                    bbox=[float(x1), float(y1), float(x2 - x1),
                          float(y2 - y1)],
                    score=float(score),
                    category_id=int(self.cat_ids[int(label)]),
                    segmentation=(mask if isinstance(mask, dict)
                                  else encode_rle(np.asarray(mask)))))
        return out

    def evaluate(self, results, metric="bbox", verbose: bool = True):
        """COCO-protocol mAP for each of ``metric`` ("bbox", "segm"):
        ``{m}_mAP``, ``{m}_mAP_50``, ``_75``, ``_s``, ``_m``, ``_l``; segm
        reads the results' masks."""
        from dsl_tpu_torch.core.eval.coco_eval import COCOEval

        metrics = [metric] if isinstance(metric, str) else list(metric)
        out = {}
        for m in metrics:
            if m not in ("bbox", "segm"):
                raise NotImplementedError(f"metric {m!r}: only 'bbox' and "
                                          f"'segm' are ported")
            dt = (self.results2json_segm(results) if m == "segm"
                  else self.results2json_bbox([r[:2] for r in results]))
            ev = COCOEval(self.coco, dt, iou_type=m,
                          img_ids=[d["id"] for d in self.data_infos],
                          cat_ids=self.cat_ids)
            stats = ev.evaluate()
            if verbose:
                ev.summarize()
            for k in ("mAP", "mAP_50", "mAP_75", "mAP_s", "mAP_m", "mAP_l"):
                out[f"{m}_{k}"] = stats[k]
        return out
