"""Dataset base class: map-style, pipeline-driven.

Counterpart of ``dsl_tpu/data/datasets/custom.py``: ``load_annotations ->
data_infos``, ``get_ann_info``, min-size and empty-GT filtering,
aspect-ratio group flags (w/h > 1), and ``prepare_train_img`` /
``prepare_test_img`` through the pipeline. The pipeline runs on ``device``
(images are decoded and transformed there) and draws from ``rng``, an
``np.random.RandomState``, and ``pyrng``, a ``random.Random`` (the JAX
package draws from the global ``np.random`` and Python's global
``random``).
"""

from __future__ import annotations

import os.path as osp
import random

import numpy as np

from dsl_tpu_torch.data.pipelines import Compose
from dsl_tpu_torch.registry import DATASETS
from dsl_tpu_torch.utils.device import resolve_device


@DATASETS.register
class CustomDataset:
    CLASSES: tuple = ()

    def __init__(self, ann_file, pipeline, classes=None, data_root=None,
                 img_prefix="", test_mode=False, filter_empty_gt=True,
                 device="cuda", rng: np.random.RandomState | None = None,
                 pyrng: random.Random | None = None, **kwargs):
        self.ann_file = ann_file
        self.data_root = data_root
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.device = resolve_device(device)
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.pyrng = pyrng if pyrng is not None else random.Random(0)
        if classes is not None:
            self.CLASSES = tuple(classes)
        if self.data_root is not None:
            if not osp.isabs(self.ann_file):
                self.ann_file = osp.join(self.data_root, self.ann_file)
            if self.img_prefix and not osp.isabs(self.img_prefix):
                self.img_prefix = osp.join(self.data_root, self.img_prefix)
        self.data_infos = self.load_annotations(self.ann_file)
        if not test_mode:
            valid_inds = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid_inds]
            self._set_group_flag()
        self.pipeline = Compose(pipeline)

    def load_annotations(self, ann_file):
        raise NotImplementedError

    def get_ann_info(self, idx):
        return self.data_infos[idx]["ann"]

    def _filter_imgs(self, min_size=32):
        valid = []
        for i, info in enumerate(self.data_infos):
            if min(info["width"], info["height"]) < min_size:
                continue
            if self.filter_empty_gt and len(self.get_ann_info(i)["bboxes"]) == 0:
                continue
            valid.append(i)
        return valid

    def _set_group_flag(self):
        self.flag = np.zeros(len(self), np.uint8)
        for i, info in enumerate(self.data_infos):
            if info["width"] / info["height"] > 1:
                self.flag[i] = 1

    def __len__(self):
        return len(self.data_infos)

    def pre_pipeline(self, results):
        results["img_prefix"] = self.img_prefix
        results["bbox_fields"] = []
        results["device"] = self.device
        return results

    def prepare_train_img(self, idx):
        results = dict(img_info=self.data_infos[idx],
                       ann_info=self.get_ann_info(idx))
        return self.pipeline(self.pre_pipeline(results), self.rng, self.pyrng)

    def prepare_test_img(self, idx):
        results = dict(img_info=self.data_infos[idx])
        return self.pipeline(self.pre_pipeline(results), self.rng, self.pyrng)

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx)
            if data is not None:
                return data
            idx = self.rng.randint(len(self))
