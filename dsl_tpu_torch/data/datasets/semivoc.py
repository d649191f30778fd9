"""Semi-supervised VOC dataset: a text image list, GT from the label store.

Counterpart of ``dsl_tpu/data/datasets/semivoc.py``: the ``ann_file`` is a
list of image file names, one a line (or a one-line JSON listing whose
``images`` carry ``file_name`` or ``filename``); each image's size is PIL's
``Image.open(path).size``, read here from the header
(``image_io.image_size(oriented=False)``: as stored, the EXIF orientation
not applied; a missing file gives 0 x 0); ground truth comes from the
per-image store with ``SemiCOCODataset``'s score triage. A COCO index of
the images (ids from 0 in list order, no annotations) lets detections be
exported: ``results2json_bbox`` writes those ids, which
``tools/generate_unlabel_annos_voc.py`` maps back to the list.
"""

from __future__ import annotations

import json
import os.path as osp

from dsl_tpu_torch.data.coco_api import COCO
from dsl_tpu_torch.data.datasets.semicoco import SemiCOCODataset
from dsl_tpu_torch.data.datasets.voc import VOC_CLASSES
from dsl_tpu_torch.data.image_io import image_size
from dsl_tpu_torch.registry import DATASETS


@DATASETS.register(name="SemiVOCDataset")
class SemiVOCDataset(SemiCOCODataset):
    CLASSES = VOC_CLASSES

    def load_annotations(self, ann_file):
        self.cat_ids = list(range(len(self.CLASSES)))
        self.cat2label = {c: c for c in self.cat_ids}
        with open(ann_file) as f:
            names = [line.strip() for line in f if line.strip()]
        if len(names) == 1 and names[0].startswith("{"):
            with open(ann_file) as f:
                listing = json.load(f)
            names = [i.get("file_name", i.get("filename"))
                     for i in listing["images"]]
        data_infos = []
        for i, name in enumerate(names):
            w, h = image_size(osp.join(self.img_prefix, name), oriented=False)
            data_infos.append(dict(filename=name, width=w, height=h, id=i))
        self.img_ids = list(range(len(data_infos)))
        self.coco = COCO(dataset=dict(
            images=[dict(id=d["id"], file_name=d["filename"],
                         width=d["width"], height=d["height"])
                    for d in data_infos],
            categories=[dict(id=c, name=self.CLASSES[c]) for c in self.cat_ids],
            annotations=[]))
        return data_infos
