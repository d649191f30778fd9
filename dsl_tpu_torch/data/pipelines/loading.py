"""Image and annotation loading transforms.

Counterpart of ``dsl_tpu/data/pipelines/loading.py`` (``LoadImageFromFile``,
``LoadAnnotations``, ``LoadProposals``). The image is read by
``data/image_io.read_image`` onto ``results["device"]`` (nvJPEG on the card,
``cv2.imread`` on the CPU): ``results["img"]`` is an (H, W, 3) uint8 BGR
tensor there. Boxes and labels stay host numpy arrays. Instance masks
(``with_mask``) are ``core/masks.BitmapMasks`` on the same device: an
RLE is decoded on the host, a polygon list rasterised on the device, an
entry of None is an empty mask; with ``poly2mask=False`` and only
polygons they stay ``PolygonMasks``, as the JAX package keeps them.
The semantic map (``with_seg``) is an (H, W) uint8 tensor on the same
device: the PNG named after the image under ``results["seg_prefix"]``,
read as ``cv2.imread(..., IMREAD_GRAYSCALE)`` reads a gray PNG (a colour
or palette PNG raises: the port's PNG reader has no route to gray for
them), or all 255 (ignored) where there is no prefix or no readable file,
as the JAX package does. No dataset puts ``seg_prefix`` in the results
(``CustomDataset`` takes a config's ``seg_prefix`` and drops it, in both
packages), so through a dataset the map is all 255.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from dsl_tpu_torch.core.masks import (
    BitmapMasks, PolygonMasks, decode_rle, rasterize_polygons)
from dsl_tpu_torch.data import png
from dsl_tpu_torch.data.image_io import read_image
from dsl_tpu_torch.registry import PIPELINES
from dsl_tpu_torch.utils.device import to_device


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
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask
        self.with_seg = with_seg
        self.poly2mask = poly2mask

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
        if self.with_mask:
            results["gt_masks"] = self._load_masks(results, ann)
            results["mask_fields"] = ["gt_masks"]
        if self.with_seg:
            results["gt_semantic_seg"] = self._load_semantic_seg(results)
            results["seg_fields"] = ["gt_semantic_seg"]
        return results

    def _load_semantic_seg(self, results) -> torch.Tensor:
        h = results["img_info"]["height"]
        w = results["img_info"]["width"]
        device = torch.device(results["device"])
        prefix = results.get("seg_prefix")
        if prefix:
            name = osp.splitext(results["img_info"]["filename"])[0] + ".png"
            seg = read_gray_png(osp.join(prefix, name), device)
            if seg is not None:
                return seg
        return torch.full((h, w), 255, dtype=torch.uint8, device=device)

    def _load_masks(self, results, ann):
        """The annotation's masks at the image's size, by the JAX package's
        rule for when polygons stay polygons."""
        h = results["img_info"]["height"]
        w = results["img_info"]["width"]
        device = torch.device(results["device"])
        polys, bitmaps = [], []
        for m in ann.get("masks", []):
            if m is None:                  # a box-only annotation
                m = []
            if isinstance(m, dict):        # uncompressed RLE
                bitmaps.append(to_device(torch.from_numpy(decode_rle(m)),
                                         device))
            else:                          # a list of flat polygons
                polys.append([np.asarray(p, np.float64) for p in m])
                bitmaps.append(rasterize_polygons(m, h, w, device))
        if self.poly2mask or not polys or len(bitmaps) != len(polys):
            return BitmapMasks(bitmaps, h, w, device)
        return PolygonMasks(polys, h, w)


def read_gray_png(path: str, device) -> torch.Tensor | None:
    """(H, W) uint8 on ``device`` as ``cv2.imread(path, IMREAD_GRAYSCALE)``
    reads a gray PNG (with or without alpha, any bit depth); None where
    OpenCV reads no image (no file, or one libpng stops on). A PNG of
    another colour type, or a file that is not a PNG, raises."""
    if not osp.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(png.SIGNATURE):
        raise NotImplementedError(f"{path}: a semantic map that is not a PNG; "
                                  f"the port reads PNG maps only")
    try:
        image = png.parse(data)
    except png.PngError:
        return None
    if image.color_type not in (0, 4):
        raise NotImplementedError(
            f"{path}: PNG colour type {image.color_type}: the port's PNG "
            f"reader has no route to gray for it (cv2.IMREAD_GRAYSCALE "
            f"mixes the channels); gray maps only")
    try:
        return png.decode(data, device)[..., 0].contiguous()
    except png.PngError:
        return None


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
