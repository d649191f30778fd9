"""Image and annotation loading transforms.

Counterpart of ``dsl_tpu/data/pipelines/loading.py`` (``LoadImageFromFile``,
``LoadAnnotations``, ``LoadProposals``) for box detection. The image is read by
``data/image_io.read_image`` onto ``results["device"]`` (nvJPEG on the card,
``cv2.imread`` on the CPU): ``results["img"]`` is an (H, W, 3) uint8 BGR
tensor there. Boxes and labels stay host numpy arrays.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from dsl_tpu_torch.data.image_io import read_image
from dsl_tpu_torch.registry import PIPELINES


@PIPELINES.register
class LoadImageFromFile:
    def __init__(self, to_float32: bool = False, color_type: str = "color"):
        if color_type != "color":
            raise NotImplementedError(
                f"LoadImageFromFile(color_type={color_type!r}): only 'color' "
                f"is ported")
        self.to_float32 = to_float32

    def __call__(self, results, rng, pyrng=None):
        if results.get("img_prefix") is not None:
            filename = osp.join(results["img_prefix"],
                                results["img_info"]["filename"])
        else:
            filename = results["img_info"]["filename"]
        img = read_image(filename, results["device"])
        if self.to_float32:
            img = img.float()
        results["filename"] = filename
        results["ori_filename"] = results["img_info"]["filename"]
        results["img"] = img
        results["img_shape"] = tuple(img.shape)
        results["ori_shape"] = tuple(img.shape)
        results["img_fields"] = ["img"]
        return results


@PIPELINES.register
class LoadAnnotations:
    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False,
                 poly2mask: bool = True):
        if with_mask or with_seg:
            raise NotImplementedError(
                "LoadAnnotations: masks and semantic segmentation are not "
                "ported yet")
        self.with_bbox = with_bbox
        self.with_label = with_label

    def __call__(self, results, rng, pyrng=None):
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = ann["bboxes"].astype(np.float32).copy()
            ignore = ann.get("bboxes_ignore")
            if ignore is None:
                ignore = np.zeros((0, 4), np.float32)
            results["gt_bboxes_ignore"] = ignore.astype(np.float32).copy()
            results["bbox_fields"] = ["gt_bboxes", "gt_bboxes_ignore"]
        if self.with_label:
            results["gt_labels"] = ann["labels"].astype(np.int64).copy()
        return results


@PIPELINES.register
class LoadProposals:
    """Proposals handed in as ``results["proposals"]`` ((n, 4) or (n, 5),
    a score column dropped), cut to ``num_max_proposals`` (one zero box
    where none is left), registered as a bbox field so that the geometric
    transforms carry them, as the JAX transform does."""

    def __init__(self, num_max_proposals: int | None = None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results, rng=None, pyrng=None):
        proposals = np.asarray(results["proposals"], np.float32)
        if proposals.ndim != 2 or proposals.shape[1] not in (4, 5):
            raise AssertionError(
                "proposals should have shapes (n, 4) or (n, 5), "
                f"but found {proposals.shape}")
        proposals = proposals[:, :4]
        if self.num_max_proposals is not None:
            proposals = proposals[:self.num_max_proposals]
        if len(proposals) == 0:
            proposals = np.asarray([[0, 0, 0, 0]], np.float32)
        results["proposals"] = proposals
        results.setdefault("bbox_fields", []).append("proposals")
        return results
