"""PASCAL VOC datasets: XML annotations and the VOC protocol's mAP.

Counterpart of ``dsl_tpu/data/datasets/voc.py``: an image-id list, one
``Annotations/<id>.xml`` per image (read with the standard library's
``xml.etree``), difficult and too small boxes as ignore boxes with their
labels, names outside ``CLASSES`` skipped, and ``evaluate`` by the VOC
protocol (``core/eval/mean_ap.eval_map``; 11-point AP where the
``img_prefix`` names ``VOC2007``, area AP otherwise). Where an XML has no
``<size>``, the size is what ``cv2.imread`` gives, read from the image's
header (``image_io.image_size(oriented=True)``: the EXIF orientation
applied; an unreadable file gives 0 x 0).
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from dsl_tpu_torch.data.datasets.custom import CustomDataset
from dsl_tpu_torch.data.image_io import image_size
from dsl_tpu_torch.registry import DATASETS

VOC_CLASSES = (
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat',
    'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')


@DATASETS.register(name="XMLDataset")
class XMLDataset(CustomDataset):
    CLASSES = VOC_CLASSES

    def __init__(self, min_size: int | None = None, img_subdir="JPEGImages",
                 ann_subdir="Annotations", **kwargs):
        self.min_size = min_size
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        super().__init__(**kwargs)
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}

    def _xml_path(self, img_id: str) -> str:
        return osp.join(self.img_prefix, self.ann_subdir, f"{img_id}.xml")

    def load_annotations(self, ann_file):
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        data_infos = []
        for img_id in ids:
            filename = osp.join(self.img_subdir, f"{img_id}.jpg")
            width = height = 0
            if osp.exists(self._xml_path(img_id)):
                size = ET.parse(self._xml_path(img_id)).getroot().find("size")
                if size is not None:
                    width = int(size.find("width").text)
                    height = int(size.find("height").text)
            if width == 0 or height == 0:
                width, height = image_size(osp.join(self.img_prefix, filename),
                                           oriented=True)
            data_infos.append(dict(id=img_id, filename=filename,
                                   width=width, height=height))
        return data_infos

    def get_ann_info(self, idx):
        bboxes, labels, ignore, ignore_labels = [], [], [], []
        xml_path = self._xml_path(self.data_infos[idx]["id"])
        if osp.exists(xml_path):
            for obj in ET.parse(xml_path).getroot().findall("object"):
                name = obj.find("name").text
                if name not in self.cat2label:
                    continue
                difficult = obj.find("difficult")
                difficult = int(difficult.text) if difficult is not None else 0
                bnd = obj.find("bndbox")
                box = [float(bnd.find(t).text)
                       for t in ("xmin", "ymin", "xmax", "ymax")]
                too_small = (self.min_size is not None
                             and (box[2] - box[0] < self.min_size
                                  or box[3] - box[1] < self.min_size))
                if difficult or too_small:
                    ignore.append(box)
                    ignore_labels.append(self.cat2label[name])
                else:
                    bboxes.append(box)
                    labels.append(self.cat2label[name])
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(ignore, np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(ignore_labels, np.int64))

    def _filter_imgs(self, min_size=32):
        valid = []
        for i, info in enumerate(self.data_infos):
            if min(info["width"], info["height"]) < min_size:
                continue
            if self.filter_empty_gt and len(self.get_ann_info(i)["bboxes"]) == 0:
                continue
            valid.append(i)
        return valid

    def evaluate(self, results, metric="mAP", iou_thr=0.5,
                 verbose: bool = False):
        """VOC-protocol AP50 / mAP of ``results`` (per image ``(dets (N, 5),
        labels (N,))`` or a per-class list of arrays), whatever ``metric``
        names, as the JAX package evaluates; 11-point AP where the
        ``img_prefix`` names ``VOC2007``."""
        from dsl_tpu_torch.core.eval.mean_ap import eval_map

        num_classes = len(self.CLASSES)
        per_class = []
        for r in results:
            if isinstance(r, tuple):
                dets, labels = r
                dets = np.asarray(dets, np.float32).reshape(-1, 5)
                labels = np.asarray(labels).reshape(-1)
                per_class.append([dets[labels == c] for c in range(num_classes)])
            else:
                per_class.append(r)
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        ds_name = "voc07" if "VOC2007" in (self.img_prefix or "") else None
        mean_ap, _ = eval_map(per_class, annotations, iou_thr=iou_thr,
                              dataset=ds_name, verbose=verbose)
        return {"mAP": mean_ap, "AP50": mean_ap if iou_thr == 0.5 else None}


@DATASETS.register(name="VOCDataset")
class VOCDataset(XMLDataset):
    CLASSES = VOC_CLASSES


@DATASETS.register(name="WIDERFaceDataset")
class WIDERFaceDataset(XMLDataset):
    """WIDER Face in PASCAL VOC XML: one ``face`` class; image files under
    the XML's ``<folder>``; the ``ann_file`` is a plain id list."""

    CLASSES = ("face",)

    def load_annotations(self, ann_file):
        with open(ann_file) as f:
            img_ids = [line.strip() for line in f if line.strip()]
        data_infos = []
        for img_id in img_ids:
            root = ET.parse(osp.join(self.img_prefix, "Annotations",
                                     f"{img_id}.xml")).getroot()
            size = root.find("size")
            data_infos.append(dict(
                id=img_id,
                filename=osp.join(root.find("folder").text, f"{img_id}.jpg"),
                width=int(size.find("width").text),
                height=int(size.find("height").text)))
        return data_infos
