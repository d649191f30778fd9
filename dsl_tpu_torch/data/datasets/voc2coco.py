"""VOC ground truth scored by the COCO protocol.

Counterpart of ``dsl_tpu/data/datasets/voc2coco.py``: the image-id list's
XMLs become an in-memory COCO index (``data/coco_api.COCO``): image ids
from 1 in list order, ``category_id`` the class index 0-19, boxes as xywh,
``ignore`` set on difficult objects, names outside ``CLASSES`` skipped.
``evaluate`` is ``CocoDataset``'s (bbox mAP@[.5:.95] and the rest), which
leaves ``ignore`` boxes out as the JAX package does.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

from dsl_tpu_torch.data.coco_api import COCO
from dsl_tpu_torch.data.datasets.coco import CocoDataset
from dsl_tpu_torch.data.datasets.voc import VOC_CLASSES
from dsl_tpu_torch.registry import DATASETS


@DATASETS.register(name="Voc2CocoDataset")
class Voc2CocoDataset(CocoDataset):
    CLASSES = VOC_CLASSES

    def __init__(self, ann_file, pipeline, img_subdir="JPEGImages",
                 ann_subdir="Annotations", **kwargs):
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        super().__init__(ann_file=ann_file, pipeline=pipeline, **kwargs)

    def load_annotations(self, ann_file):
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        cat2id = {c: i for i, c in enumerate(self.CLASSES)}
        images, annotations = [], []
        for img_idx, img_id in enumerate(ids):
            xml_path = osp.join(self.img_prefix, self.ann_subdir,
                                f"{img_id}.xml")
            width = height = 0
            objs = []
            if osp.exists(xml_path):
                root = ET.parse(xml_path).getroot()
                size = root.find("size")
                if size is not None:
                    width = int(size.find("width").text)
                    height = int(size.find("height").text)
                objs = root.findall("object")
            images.append(dict(
                id=img_idx + 1,
                file_name=osp.join(self.img_subdir, f"{img_id}.jpg"),
                width=width, height=height))
            for obj in objs:
                name = obj.find("name").text
                if name not in cat2id:
                    continue
                difficult = obj.find("difficult")
                difficult = int(difficult.text) if difficult is not None else 0
                bnd = obj.find("bndbox")
                x1, y1, x2, y2 = [float(bnd.find(t).text)
                                  for t in ("xmin", "ymin", "xmax", "ymax")]
                annotations.append(dict(
                    id=len(annotations) + 1, image_id=img_idx + 1,
                    category_id=cat2id[name], bbox=[x1, y1, x2 - x1, y2 - y1],
                    area=(x2 - x1) * (y2 - y1), iscrowd=0, ignore=difficult))
        self.coco = COCO(dataset=dict(
            images=images,
            categories=[dict(id=i, name=c) for i, c in enumerate(self.CLASSES)],
            annotations=annotations))
        self.cat_ids = list(range(len(self.CLASSES)))
        self.cat2label = {c: c for c in self.cat_ids}
        self.img_ids = self.coco.get_img_ids()
        return [dict(info, filename=info["file_name"]) for info in images]
