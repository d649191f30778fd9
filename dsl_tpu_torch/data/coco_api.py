"""Minimal COCO annotation index, in place of pycocotools' COCO class.

The port's own copy of ``dsl_tpu/data/coco_api.py`` (the port imports
nothing of the JAX package): imgs/anns/cats indices,
get_img_ids/get_cat_ids/get_ann_ids, load_imgs/load_anns, img->anns map.
"""

from __future__ import annotations

import json
from collections import defaultdict


class COCO:
    def __init__(self, annotation_file: str | None = None,
                 dataset: dict | None = None):
        if annotation_file is not None:
            with open(annotation_file, "r", encoding="utf-8") as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self.imgs = {}
        self.anns = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(set)
        self._index()

    def _index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            self.cat_to_imgs[ann["category_id"]].add(ann["image_id"])

    # -- ids ---------------------------------------------------------------
    def get_img_ids(self) -> list:
        return list(self.imgs.keys())

    def get_cat_ids(self, cat_names=None) -> list:
        if cat_names is None:
            return list(self.cats.keys())
        name_to_id = {c["name"]: cid for cid, c in self.cats.items()}
        return [name_to_id[n] for n in cat_names]

    def get_ann_ids(self, img_ids=None, cat_ids=None) -> list:
        anns = []
        if img_ids is not None:
            for i in img_ids:
                anns.extend(self.img_to_anns.get(i, []))
        else:
            anns = list(self.anns.values())
        if cat_ids is not None:
            cs = set(cat_ids)
            anns = [a for a in anns if a["category_id"] in cs]
        return [a["id"] for a in anns]

    # -- load --------------------------------------------------------------
    def load_imgs(self, ids) -> list:
        return [self.imgs[i] for i in ids]

    def load_anns(self, ids) -> list:
        return [self.anns[i] for i in ids]

    def load_cats(self, ids) -> list:
        return [self.cats[i] for i in ids]

    # camelCase aliases for familiarity with the pycocotools surface
    getImgIds = get_img_ids
    getCatIds = get_cat_ids
    getAnnIds = get_ann_ids
    loadImgs = load_imgs
    loadAnns = load_anns
    loadCats = load_cats
