"""mmdet's other training transforms on device tensors.

Counterpart of ``dsl_tpu/data/pipelines/extra_transforms.py``:
``RandomCrop``, ``MinIoURandomCrop``, ``Expand``, ``PhotoMetricDistortion``,
``CutOut``, ``RandomShift`` and the box-aware ``AutoAugment`` policy
wrapper. Every draw comes from ``rng`` (an ``np.random.RandomState``) in
the JAX package's order of ``np.random`` calls, ``MinIoURandomCrop``'s
retry loop included (a mode, then up to 50 tries of two sizes, and two
corners only for a size of an accepted aspect, until a crop passes).
Images stay tensors on their device (crops are views; fills and the colour
chain are torch ops); boxes stay host numpy arrays, transformed by the JAX
package's host code.

``PhotoMetricDistortion`` returns float32, as there: its HSV round trip is
``image_ops.bgr_to_hsv_cv`` / ``hsv_to_bgr_cv``, OpenCV's uint8
conversions bit for bit; the scalar draws enter float32 arithmetic rounded
to float, as numpy's does with a Python float; the hue's ``% 180`` is
``fmod`` then ``+ 180`` below zero, numpy's ``remainder``.
"""

from __future__ import annotations

import numpy as np
import torch

from dsl_tpu_torch.data.pipelines import image_ops as ops
from dsl_tpu_torch.data.pipelines.compose import Compose
from dsl_tpu_torch.registry import PIPELINES
from dsl_tpu_torch.utils.device import to_device

_NUMPY = {torch.uint8: np.uint8, torch.float32: np.float32,
          torch.float64: np.float64}


def _bbox_fields(results):
    return results.get("bbox_fields", [])


def _fill_values(fill, dtype: torch.dtype, channels: int) -> list:
    """``fill`` cast to the image's type as numpy's assignment casts it,
    one value per channel."""
    vals = np.broadcast_to(np.asarray(fill).astype(_NUMPY[dtype]), (channels,))
    return vals.tolist()


def _fill_mask(img: torch.Tensor, mask: np.ndarray, fill) -> torch.Tensor:
    """``img`` with the host mask's pixels set to ``fill``: the mask and
    the fill reach the device through pinned memory; one ``torch.where``."""
    vals = torch.tensor(_fill_values(fill, img.dtype, img.shape[2]),
                        dtype=img.dtype)
    return torch.where(to_device(torch.from_numpy(mask), img.device)[..., None],
                       to_device(vals, img.device), img)


@PIPELINES.register
class RandomCrop:
    """A random crop with the boxes clipped; None when no GT box survives
    and ``allow_negative_crop`` is off (the dataset then draws another
    image)."""

    def __init__(self, crop_size, allow_negative_crop: bool = False):
        self.crop_size = tuple(crop_size)   # (h, w)
        self.allow_negative_crop = allow_negative_crop

    def __call__(self, results, rng, pyrng=None):
        img = results["img"]
        h, w = img.shape[:2]
        ch = min(self.crop_size[0], h)
        cw = min(self.crop_size[1], w)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        results["img"] = img[y0:y0 + ch, x0:x0 + cw]
        results["img_shape"] = tuple(results["img"].shape)
        for key in _bbox_fields(results):
            boxes = results[key]
            if len(boxes) == 0:
                continue
            boxes = boxes - np.asarray([x0, y0, x0, y0], np.float32)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, cw)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ch)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            results[key] = boxes[keep]
            if key == "gt_bboxes":
                results["gt_labels"] = results["gt_labels"][keep]
                if not keep.any() and not self.allow_negative_crop:
                    return None
        return results


@PIPELINES.register
class MinIoURandomCrop:
    """SSD's IoU-constrained random crop: draw a minimum IoU from the list
    (1 keeps the image), try 50 crops whose IoU with every GT box reaches
    it and that hold a box centre, keep the boxes whose centres fall
    inside; draw a new mode after 50 failures."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                 min_crop_size=0.3):
        self.min_ious = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size

    def __call__(self, results, rng, pyrng=None):
        img = results["img"]
        h, w = img.shape[:2]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        while True:
            mode = rng.choice(self.min_ious)
            if mode == 1:
                return results
            for _ in range(50):
                nw = rng.uniform(self.min_crop_size * w, w)
                nh = rng.uniform(self.min_crop_size * h, h)
                if nh / nw < 0.5 or nh / nw > 2:
                    continue
                x0 = rng.uniform(0, w - nw)
                y0 = rng.uniform(0, h - nh)
                patch = np.asarray([x0, y0, x0 + nw, y0 + nh])
                if len(boxes):
                    ix1 = np.maximum(boxes[:, 0], patch[0])
                    iy1 = np.maximum(boxes[:, 1], patch[1])
                    ix2 = np.minimum(boxes[:, 2], patch[2])
                    iy2 = np.minimum(boxes[:, 3], patch[3])
                    inter = (np.clip(ix2 - ix1, 0, None)
                             * np.clip(iy2 - iy1, 0, None))
                    area_b = ((boxes[:, 2] - boxes[:, 0])
                              * (boxes[:, 3] - boxes[:, 1]))
                    ious = inter / np.maximum(area_b + nw * nh - inter, 1e-10)
                    if ious.min() < mode:
                        continue
                    cx = (boxes[:, 0] + boxes[:, 2]) / 2
                    cy = (boxes[:, 1] + boxes[:, 3]) / 2
                    keep = ((cx > patch[0]) & (cx < patch[2])
                            & (cy > patch[1]) & (cy < patch[3]))
                    if not keep.any():
                        continue
                else:
                    keep = np.zeros((0,), bool)
                results["img"] = img[int(y0):int(y0 + nh), int(x0):int(x0 + nw)]
                results["img_shape"] = tuple(results["img"].shape)
                for key in _bbox_fields(results):
                    bx = results[key]
                    if len(bx) == 0:
                        continue
                    if key == "gt_bboxes":
                        bx = bx[keep]
                        results["gt_labels"] = results["gt_labels"][keep]
                    bx = bx - np.asarray([x0, y0, x0, y0], np.float32)
                    bx[:, 0::2] = np.clip(bx[:, 0::2], 0, nw)
                    bx[:, 1::2] = np.clip(bx[:, 1::2], 0, nh)
                    results[key] = bx
                return results


@PIPELINES.register
class Expand:
    """SSD's zoom-out: the image placed in a larger canvas of ``mean``."""

    def __init__(self, mean=(0, 0, 0), ratio_range=(1, 4), prob=0.5):
        self.mean = tuple(mean)
        self.ratio_range = ratio_range
        self.prob = prob

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.prob:
            return results
        img = results["img"]
        h, w, c = img.shape
        ratio = rng.uniform(*self.ratio_range)
        eh, ew = int(h * ratio), int(w * ratio)
        top = rng.randint(0, eh - h + 1)
        left = rng.randint(0, ew - w + 1)
        canvas = img.new_empty((eh, ew, c))
        for ch, value in enumerate(_fill_values(self.mean, img.dtype, c)):
            canvas[..., ch].fill_(value)
        canvas[top:top + h, left:left + w] = img
        results["img"] = canvas
        results["img_shape"] = tuple(canvas.shape)
        shift = np.asarray([left, top, left, top], np.float32)
        for key in _bbox_fields(results):
            if len(results[key]):
                results[key] = results[key] + shift
        return results


def _hue_mod(h: torch.Tensor) -> torch.Tensor:
    """numpy's ``h % 180`` on float32: ``fmod``, then ``+ 180`` where the
    remainder is below zero."""
    m = torch.fmod(h, 180.0)
    return torch.where(m < 0, m + 180.0, m)


@PIPELINES.register
class PhotoMetricDistortion:
    """SSD's photometric chain: brightness, contrast (before or after),
    saturation and hue through OpenCV's uint8 HSV; returns float32."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results, rng, pyrng=None):
        f = ops._c_float
        img = results["img"].to(torch.float32)
        if rng.randint(2):
            img = img + f(rng.uniform(-self.brightness_delta,
                                      self.brightness_delta))
        contrast_first = rng.randint(2)
        if contrast_first and rng.randint(2):
            img = img * f(rng.uniform(*self.contrast_range))
        hsv = ops.bgr_to_hsv_cv(ops.saturate_trunc_u8(img)).to(torch.float32)
        if rng.randint(2):
            hsv[..., 1] = hsv[..., 1] * f(rng.uniform(*self.saturation_range))
        if rng.randint(2):
            hsv[..., 0] = _hue_mod(hsv[..., 0] + f(rng.uniform(
                -self.hue_delta, self.hue_delta)))
        img = ops.hsv_to_bgr_cv(ops.saturate_trunc_u8(hsv)).to(torch.float32)
        if not contrast_first and rng.randint(2):
            img = img * f(rng.uniform(*self.contrast_range))
        results["img"] = img.clamp(0, 255)
        return results


@PIPELINES.register
class CutOut:
    """Fill ``n`` random rectangles with ``fill_in``."""

    def __init__(self, n_holes, cutout_shape=None, cutout_ratio=None,
                 fill_in=(0, 0, 0)):
        self.n_holes = n_holes if isinstance(n_holes, tuple) else \
            (n_holes, n_holes)
        self.cutout_shape = cutout_shape
        self.cutout_ratio = cutout_ratio
        self.fill_in = fill_in

    def __call__(self, results, rng, pyrng=None):
        img = results["img"]
        h, w = img.shape[:2]
        n = rng.randint(self.n_holes[0], self.n_holes[1] + 1)
        mask = np.zeros((h, w), bool)
        for _ in range(n):
            if self.cutout_ratio is not None:
                ratios = self.cutout_ratio
                idx = rng.randint(len(ratios))
                ch, cw = int(h * ratios[idx][0]), int(w * ratios[idx][1])
            else:
                shapes = self.cutout_shape
                idx = rng.randint(len(shapes))
                ch, cw = shapes[idx]
            y0 = rng.randint(0, h)
            x0 = rng.randint(0, w)
            mask[y0:min(y0 + ch, h), x0:min(x0 + cw, w)] = True
        if mask.any():
            results["img"] = _fill_mask(img, mask, self.fill_in)
        return results


@PIPELINES.register
class RandomShift:
    """Shift the image and boxes by up to ``max_shift_px`` with probability
    ``shift_ratio``; boxes under ``filter_thr_px`` wide or high go."""

    def __init__(self, shift_ratio=0.5, max_shift_px=32, filter_thr_px=1):
        self.shift_ratio = shift_ratio
        self.max_shift_px = max_shift_px
        self.filter_thr_px = filter_thr_px

    def __call__(self, results, rng, pyrng=None):
        if rng.rand() > self.shift_ratio:
            return results
        img = results["img"]
        h, w = img.shape[:2]
        dx = rng.randint(-self.max_shift_px, self.max_shift_px + 1)
        dy = rng.randint(-self.max_shift_px, self.max_shift_px + 1)
        canvas = torch.zeros_like(img)
        ys, ye = max(dy, 0), min(h + dy, h)
        xs, xe = max(dx, 0), min(w + dx, w)
        if ye > ys and xe > xs:
            canvas[ys:ye, xs:xe] = img[ys - dy:ye - dy, xs - dx:xe - dx]
        results["img"] = canvas
        for key in _bbox_fields(results):
            boxes = results[key]
            if len(boxes) == 0:
                continue
            boxes = boxes + np.asarray([dx, dy, dx, dy], np.float32)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
            keep = ((boxes[:, 2] - boxes[:, 0] > self.filter_thr_px)
                    & (boxes[:, 3] - boxes[:, 1] > self.filter_thr_px))
            results[key] = boxes[keep]
            if key == "gt_bboxes":
                results["gt_labels"] = results["gt_labels"][keep]
        return results


@PIPELINES.register
class AutoAugment:
    """Box-aware AutoAugment: one of ``policies`` (each a list of
    transform configs, built through the port's ``Compose``) at random."""

    def __init__(self, policies):
        self.policies = [Compose(p) for p in policies]

    def __call__(self, results, rng, pyrng=None):
        policy = self.policies[rng.randint(len(self.policies))]
        return policy(results, rng, pyrng)
