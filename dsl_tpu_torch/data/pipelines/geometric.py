"""Box-aware geometric and photometric AutoAugment transforms on device
tensors.

Counterpart of ``dsl_tpu/data/pipelines/geometric.py`` (mmdet's
``auto_augment.py``): ``Shear``, ``Rotate``, ``Translate``,
``ColorTransform``, ``EqualizeTransform``, ``BrightnessTransform`` and
``ContrastTransform``, with the mmcv image ops they call (``imshear``,
``imtranslate``, ``imrotate``, ``adjust_color``, ``imequalize``,
``adjust_brightness``, ``adjust_contrast``). The image is an (H, W, 3)
uint8 tensor on its device and every op is bit for bit the OpenCV call the
JAX package makes: ``cv2.warpAffine`` (bilinear, a per-channel constant
border) through ``image_ops.warp_affine``, ``cv2.addWeighted`` through
``image_ops.add_weighted``, ``np.histogram(im, 256, (0, 255))`` as a device
bincount (each integer level falls in its own bin). The contrast's mean
(``round(sum(gray) / count)``, half to even) stays a device value, so no
transform waits for the card. Boxes stay host numpy arrays, transformed by
the JAX package's host code. Random draws come from ``rng`` (an
``np.random.RandomState``) in the JAX package's order of ``np.random``
calls. Mask and segmentation fields are not ported and raise, naming the
field; a float image raises ``TypeError``.
"""

from __future__ import annotations

import numpy as np
import torch

from dsl_tpu_torch.data.pipelines import image_ops as ops
from dsl_tpu_torch.registry import PIPELINES

_MAX_LEVEL = 10


def level_to_value(level, max_value):
    return (level / _MAX_LEVEL) * max_value


def enhance_level_to_value(level, a=1.8, b=0.1):
    return (level / _MAX_LEVEL) * a + b


def _border3(border_value) -> tuple:
    if isinstance(border_value, (int, float)):
        return tuple([float(border_value)] * 3)
    return tuple(float(v) for v in border_value)


def _u8(img: torch.Tensor, what: str) -> torch.Tensor:
    if img.dtype != torch.uint8:
        raise TypeError(f"{what} takes a uint8 image, not {img.dtype}")
    return img


def _warp(img, matrix, border_value, interpolation, what):
    if interpolation != "bilinear":
        raise NotImplementedError(f"{what}(interpolation={interpolation!r}): "
                                  f"only 'bilinear' is ported")
    return ops.warp_affine(_u8(img, what), matrix, _border3(border_value))


def imshear(img: torch.Tensor, magnitude, direction="horizontal",
            border_value=0, interpolation="bilinear") -> torch.Tensor:
    """mmcv ``imshear``: ``cv2.warpAffine`` with the float32 matrix
    [[1, m, 0], [0, 1, 0]] (horizontal) or [[1, 0, 0], [m, 1, 0]]."""
    m = float(np.float32(magnitude))
    matrix = ([[1, m, 0], [0, 1, 0]] if direction == "horizontal"
              else [[1, 0, 0], [m, 1, 0]])
    return _warp(img, matrix, border_value, interpolation, "imshear")


def imtranslate(img: torch.Tensor, offset, direction="horizontal",
                border_value=0, interpolation="bilinear") -> torch.Tensor:
    """mmcv ``imtranslate``."""
    o = float(np.float32(offset))
    matrix = ([[1, 0, o], [0, 1, 0]] if direction == "horizontal"
              else [[1, 0, 0], [0, 1, o]])
    return _warp(img, matrix, border_value, interpolation, "imtranslate")


def imrotate(img: torch.Tensor, angle, center=None, scale=1.0,
             border_value=0, interpolation="bilinear") -> torch.Tensor:
    """mmcv ``imrotate``: a positive angle turns clockwise; the centre
    defaults to ((w - 1) / 2, (h - 1) / 2)."""
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    matrix = ops.get_rotation_matrix_2d(center, -angle, scale)
    return _warp(img, matrix, border_value, interpolation, "imrotate")


def _blend(img: torch.Tensor, other: torch.Tensor, alpha: float,
           beta: float, gamma: float = 0.0) -> torch.Tensor:
    """``np.clip(cv2.addWeighted(img f32, alpha, other f32, beta, gamma),
    0, 255).astype(uint8)``."""
    return ops.saturate_trunc_u8(ops.add_weighted(img, alpha, other, beta,
                                                  gamma))


def adjust_color(img: torch.Tensor, alpha=1.0, beta=None, gamma=0):
    """mmcv ``adjust_color``: a blend with the grayscale image."""
    gray = ops.bgr_to_gray_cv(_u8(img, "adjust_color"))
    beta = 1 - alpha if beta is None else beta
    return _blend(img, gray[..., None].expand_as(img), alpha, beta, gamma)


def imequalize(img: torch.Tensor) -> torch.Tensor:
    """mmcv ``imequalize``: per channel, ``step = (count - h[last used
    level]) // 255`` and ``lut[i] = (sum(h[:i]) + step // 2) // step``,
    the identity where ``step`` is 0: ``image_ops.equalize``, whose device
    bincount gives ``np.histogram(im, 256, (0, 255))``'s bins."""
    return ops.equalize(_u8(img, "imequalize"))


def adjust_brightness(img: torch.Tensor, factor=1.0) -> torch.Tensor:
    """mmcv ``adjust_brightness``: a blend with a black image."""
    _u8(img, "adjust_brightness")
    return _blend(img, torch.zeros_like(img), factor, 1 - factor)


def adjust_contrast(img: torch.Tensor, factor=1.0) -> torch.Tensor:
    """mmcv ``adjust_contrast``: a blend with a flat image at the gray
    image's mean, ``round(sum / count)`` half to even, on the device."""
    gray = ops.bgr_to_gray_cv(_u8(img, "adjust_contrast"))
    mean = torch.round(gray.to(torch.int64).sum().to(torch.float64)
                       / gray.numel()).to(torch.uint8)
    return _blend(img, mean.expand_as(img), factor, 1 - factor)


def _refuse_masks(results, what: str):
    for key in ("mask_fields", "seg_fields"):
        if results.get(key):
            raise NotImplementedError(
                f"{what}: {key} {results[key]} are not ported for this "
                f"transform yet")


def _bbox_fields(results):
    fields = list(results.get("bbox_fields", []))
    if "gt_bboxes" in results and "gt_bboxes" not in fields:
        fields.append("gt_bboxes")
    return fields


_BOX2LABEL = {"gt_bboxes": "gt_labels",
              "gt_bboxes_ignore": "gt_labels_ignore"}


def _filter_invalid(results, min_size=0):
    """Drop boxes (and their labels) with w or h <= ``min_size``."""
    for key in _bbox_fields(results):
        boxes = results[key]
        keep = ((boxes[:, 2] - boxes[:, 0] > min_size)
                & (boxes[:, 3] - boxes[:, 1] > min_size))
        keep = np.nonzero(keep)[0]
        results[key] = boxes[keep]
        lk = _BOX2LABEL.get(key)
        if lk in results:
            results[lk] = results[lk][keep]


def _warp_boxes(results, mat, homogeneous: bool):
    """Warp every box's corners, then min/max and clip to the image, in
    the JAX package's order."""
    h, w = results["img_shape"][:2]
    for key in _bbox_fields(results):
        boxes = results[key]
        if len(boxes) == 0:
            continue
        x1, y1, x2, y2 = [boxes[:, i] for i in range(4)]
        corners = np.stack([
            np.stack([x1, y1], 0), np.stack([x2, y1], 0),
            np.stack([x1, y2], 0), np.stack([x2, y2], 0)])  # (4, 2, n)
        corners = corners.transpose(2, 1, 0).astype(np.float32)  # (n, 2, 4)
        if homogeneous:
            ones = np.ones((len(boxes), 1, 4), np.float32)
            pts = np.concatenate([corners, ones], axis=1)
        else:
            pts = corners
        new = np.matmul(np.asarray(mat)[None].astype(np.float32), pts)
        min_x = np.clip(new[:, 0].min(-1), 0, w)
        min_y = np.clip(new[:, 1].min(-1), 0, h)
        max_x = np.clip(new[:, 0].max(-1), min_x, w)
        max_y = np.clip(new[:, 1].max(-1), min_y, h)
        results[key] = np.stack([min_x, min_y, max_x, max_y],
                                axis=-1).astype(boxes.dtype)


@PIPELINES.register
class Shear:
    def __init__(self, level, img_fill_val=128, seg_ignore_label=255,
                 prob=0.5, direction="horizontal", max_shear_magnitude=0.3,
                 random_negative_prob=0.5, interpolation="bilinear"):
        assert direction in ("horizontal", "vertical")
        self.level = level
        self.magnitude = level_to_value(level, max_shear_magnitude)
        self.img_fill_val = _border3(img_fill_val)
        self.prob = prob
        self.direction = direction
        self.random_negative_prob = random_negative_prob
        self.interpolation = interpolation

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.prob:
            return results
        _refuse_masks(results, "Shear")
        magnitude = self.magnitude
        if rng.rand() < self.random_negative_prob:
            magnitude = -magnitude
        results["img"] = imshear(results["img"], magnitude, self.direction,
                                 self.img_fill_val, self.interpolation)
        mat = ([[1, magnitude], [0, 1]] if self.direction == "horizontal"
               else [[1, 0], [magnitude, 1]])
        _warp_boxes(results, np.float32(mat), homogeneous=False)
        _filter_invalid(results)
        return results


@PIPELINES.register
class Rotate:
    def __init__(self, level, scale=1, center=None, img_fill_val=128,
                 seg_ignore_label=255, prob=0.5, max_rotate_angle=30,
                 random_negative_prob=0.5):
        self.level = level
        self.scale = scale
        self.angle = level_to_value(level, max_rotate_angle)
        self.center = center
        self.img_fill_val = _border3(img_fill_val)
        self.prob = prob
        self.random_negative_prob = random_negative_prob

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.prob:
            return results
        _refuse_masks(results, "Rotate")
        h, w = results["img"].shape[:2]
        center = self.center
        if center is None:
            center = ((w - 1) * 0.5, (h - 1) * 0.5)
        angle = self.angle
        if rng.rand() < self.random_negative_prob:
            angle = -angle
        results["img"] = imrotate(results["img"], angle, center, self.scale,
                                  self.img_fill_val)
        mat = ops.get_rotation_matrix_2d(center, -angle, self.scale)
        _warp_boxes(results, mat, homogeneous=True)
        _filter_invalid(results)
        return results


@PIPELINES.register
class Translate:
    def __init__(self, level, prob=0.5, img_fill_val=128,
                 seg_ignore_label=255, direction="horizontal",
                 max_translate_offset=250., random_negative_prob=0.5,
                 min_size=0):
        assert direction in ("horizontal", "vertical")
        self.level = level
        self.offset = int(level_to_value(level, max_translate_offset))
        self.prob = prob
        self.img_fill_val = _border3(img_fill_val)
        self.direction = direction
        self.random_negative_prob = random_negative_prob
        self.min_size = min_size

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.prob:
            return results
        _refuse_masks(results, "Translate")
        offset = self.offset
        if rng.rand() < self.random_negative_prob:
            offset = -offset
        results["img"] = imtranslate(results["img"], offset, self.direction,
                                     self.img_fill_val)
        h, w = results["img_shape"][:2]
        for key in _bbox_fields(results):
            boxes = results[key].copy().astype(np.float32)
            if len(boxes):
                if self.direction == "horizontal":
                    boxes[:, 0] = np.maximum(0, boxes[:, 0] + offset)
                    boxes[:, 2] = np.minimum(w, boxes[:, 2] + offset)
                else:
                    boxes[:, 1] = np.maximum(0, boxes[:, 1] + offset)
                    boxes[:, 3] = np.minimum(h, boxes[:, 3] + offset)
            results[key] = boxes
        _filter_invalid(results, min_size=self.min_size)
        return results


class _Enhance:
    """A photometric AutoAugment transform: with probability ``prob``,
    ``op(img, factor)``."""

    op = None

    def __init__(self, level, prob=0.5):
        self.level = level
        self.prob = prob
        self.factor = enhance_level_to_value(level)

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.prob:
            return results
        results["img"] = type(self).op(results["img"], self.factor)
        return results


@PIPELINES.register
class ColorTransform(_Enhance):
    op = staticmethod(adjust_color)


@PIPELINES.register
class BrightnessTransform(_Enhance):
    op = staticmethod(adjust_brightness)


@PIPELINES.register
class ContrastTransform(_Enhance):
    op = staticmethod(adjust_contrast)


@PIPELINES.register
class EqualizeTransform:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.prob:
            return results
        results["img"] = imequalize(results["img"])
        return results
