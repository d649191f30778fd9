"""Geometric and photometric transforms on device tensors.

Counterpart of the part of ``dsl_tpu/data/pipelines/transforms.py`` the
flagship config runs: ``Resize`` (a list of scales, ``multiscale_mode``
'value' or 'range', ``keep_ratio``), ``PatchShuffle``, ``RandomFlip``,
``Normalize``, ``Pad`` (``size_divisor``) and ``MultiScaleFlipAug``, and
DSL's ``ZeroIgnore``.
``results["img"]`` is an (H, W, 3) tensor on its device; boxes are host
numpy arrays, transformed as the JAX package does. Random draws come from
the ``rng`` argument (an ``np.random.RandomState``) in the JAX package's
order of ``np.random`` calls, and from ``pyrng`` (a ``random.Random``) where
the JAX package calls Python's ``random``.

Resize is ``image_ops.resize_linear_u8``, or ``resize_linear_f32`` on the
float32 image of a ``to_float32`` load or ``PhotoMetricDistortion``: bit
for bit ``cv2.resize``'s ``INTER_LINEAR`` on uint8, and on float32 up to
an 8x upscale. ``Resize``, ``RandomFlip`` and ``Pad`` carry the instance
masks of ``results["mask_fields"]`` as the JAX transforms do (nearest
resize, flip, zero pad of ``core/masks.BitmapMasks``); a ``PolygonMasks``
has no ``resize`` and no ``pad`` in either package, so ``Resize`` and
``Pad`` fail on it. They carry the semantic maps of
``results["seg_fields"]`` too (an (H, W) uint8 tensor: OpenCV's
``INTER_NEAREST`` resize by ``image_ops.resize_nearest``, the flip, a pad
of 255), and ``SegRescale`` resizes them by a factor, the size rounded as
``int(x * s + 0.5)``, as the JAX transforms do.
"""

from __future__ import annotations

import numpy as np
import torch

from dsl_tpu_torch.data.image_io import read_image
from dsl_tpu_torch.data.pipelines.compose import Compose
from dsl_tpu_torch.data.pipelines.image_ops import (
    resize_linear_f32, resize_linear_u8, resize_nearest)
from dsl_tpu_torch.registry import PIPELINES
from dsl_tpu_torch.utils.device import to_device


def keep_ratio_size(h: int, w: int, scale) -> tuple[int, int]:
    """(new_h, new_w) that fits (h, w) into ``scale`` = (long, short) edges,
    rounded as mmcv's ``rescale_size``."""
    factor = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5)


def read_resized(path, img_scale, device, flip: bool = False
                 ) -> tuple[torch.Tensor, list, list]:
    """An image file read onto ``device`` and resized keeping its ratio to
    ``img_scale``: (uint8 image, [nh, nw], scale factor [w, h, w, h]).
    ``flip`` mirrors the decoded image before the resize, as the JAX
    package's test-time flip does (``img[:, ::-1]``, then ``cv2.resize``)."""
    img = read_image(path, device)
    if flip:
        img = img.flip(1)
    h, w = img.shape[:2]
    nh, nw = keep_ratio_size(h, w, img_scale)
    return resize_linear_u8(img, nh, nw), [nh, nw], [nw / w, nh / h, nw / w, nh / h]


@PIPELINES.register
class Resize:
    """Resize image and boxes. ``img_scale`` holds (long, short) tuples."""

    def __init__(self, img_scale=None, multiscale_mode="range",
                 keep_ratio=True, bbox_clip_border=True):
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.multiscale_mode = multiscale_mode
        self.keep_ratio = keep_ratio
        self.bbox_clip_border = bbox_clip_border

    def _pick_scale(self, rng):
        if len(self.img_scale) == 1:
            return self.img_scale[0], 0
        if self.multiscale_mode == "value":
            idx = rng.randint(len(self.img_scale))
            return self.img_scale[idx], idx
        longs = [max(s) for s in self.img_scale]
        shorts = [min(s) for s in self.img_scale]
        long_edge = rng.randint(min(longs), max(longs) + 1)
        short_edge = rng.randint(min(shorts), max(shorts) + 1)
        return (long_edge, short_edge), None

    def __call__(self, results, rng, pyrng=None):
        if results.get("scale") is not None:
            scale, scale_idx = tuple(results["scale"]), results.get("scale_idx")
        else:
            scale, scale_idx = self._pick_scale(rng)
        img = results["img"]
        h, w = img.shape[:2]
        if self.keep_ratio:
            new_h, new_w = keep_ratio_size(h, w, scale)
        else:
            new_w, new_h = scale[0], scale[1]
        resize = (resize_linear_f32 if img.dtype == torch.float32
                  else resize_linear_u8)
        out = resize(img, new_h, new_w)
        w_scale, h_scale = new_w / w, new_h / h
        results["img"] = out
        results["img_shape"] = tuple(out.shape)
        results["pad_shape"] = tuple(out.shape)
        results["scale_factor"] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results["scale"] = scale
        results["scale_idx"] = scale_idx
        results["keep_ratio"] = self.keep_ratio
        for key in results.get("bbox_fields", []):
            boxes = results[key]
            if len(boxes) == 0:
                continue
            boxes = boxes * results["scale_factor"]
            if self.bbox_clip_border:
                boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, new_w)
                boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, new_h)
            results[key] = boxes
        for key in results.get("mask_fields", []):
            results[key] = results[key].resize((new_h, new_w))
        for key in results.get("seg_fields", []):
            results[key] = resize_nearest(results[key], new_h, new_w)
        return results


@PIPELINES.register
class PatchShuffle:
    """DSL strong augmentation: cut the image at a random fraction of its
    width ('flip') or height ('flop'), swap the two pieces (a roll on the
    device), and move the boxes, splitting those across the seam. The
    boxes' remapping is the JAX package's host code, including its test of
    a box against the seam, which also compares the other axis with the
    full height (width), so a box reaching the last row ('flip') or column
    ('flop') is split into a moved box and an inverted one."""

    def __init__(self, ratio=0.5, ranges=(0.2, 0.8), mode=("flip", "flop")):
        self.ratio = ratio
        self.ranges = list(ranges)
        self.mode = list(mode)

    def __call__(self, results, rng, pyrng):
        if rng.rand() > self.ratio:
            results["PS"] = False
            results["PS_place"] = None
            results["PS_mode"] = None
            return results
        img = results["img"]
        h, w = img.shape[:2]
        place = (rng.rand() * abs(self.ranges[1] - self.ranges[0])
                 + self.ranges[0])
        mode = pyrng.choice(self.mode)
        results["PS"], results["PS_place"], results["PS_mode"] = (
            True, place, mode)
        if mode == "flip":
            crop_w, crop_h = min(int(round(w * place)), w), h
            if crop_w in (0, w):
                return results
            img = torch.roll(img, -crop_w, 1)
        else:  # 'flop'
            crop_h, crop_w = min(int(round(h * place)), h), w
            if crop_h in (0, h):
                return results
            img = torch.roll(img, -crop_h, 0)
        results["img"] = img

        for key in results.get("bbox_fields", []):
            boxes = results[key]
            if len(boxes) == 0:
                continue
            new_boxes, new_labels = [], []
            labels = results.get("gt_labels") if key == "gt_bboxes" else None
            for i, (x1, y1, x2, y2) in enumerate(boxes):
                # box entirely on one side of the seam?
                whole = ((x1 - crop_w + 1) * (x2 - crop_w + 1) >= 0
                         and (y1 - crop_h + 1) * (y2 - crop_h + 1) >= 0)
                if whole:
                    if mode == "flip":
                        if x1 - crop_w + 1 < 0:      # left piece -> right
                            x1, x2 = x1 + w - crop_w, x2 + w - crop_w
                        elif x2 - crop_w + 1 > 0:    # right piece -> left
                            x1, x2 = x1 - crop_w, x2 - crop_w
                    else:
                        if y1 - crop_h + 1 < 0:
                            y1, y2 = y1 + h - crop_h, y2 + h - crop_h
                        elif y2 - crop_h + 1 > 0:
                            y1, y2 = y1 - crop_h, y2 - crop_h
                    new_boxes.append([x1, y1, x2, y2])
                    if labels is not None:
                        new_labels.append(labels[i])
                else:
                    # box across the seam: split into two boxes
                    if mode == "flip":
                        new_boxes.append([x1 + w - crop_w, y1, w - 1, y2])
                        new_boxes.append([0, y1, x2 - crop_w, y2])
                    else:
                        new_boxes.append([x1, y1 + h - crop_h, x2, h - 1])
                        new_boxes.append([x1, 0, x2, y2 - crop_h])
                    if labels is not None:
                        new_labels.extend([labels[i], labels[i]])
            results[key] = np.asarray(new_boxes, np.float32).reshape(-1, 4)
            if labels is not None:
                results["gt_labels"] = np.asarray(new_labels, np.int64)
        return results


@PIPELINES.register
class ZeroIgnore:
    """DSL's blank of the ignore regions of pseudo-labels: each ignore box
    that overlaps no GT box (the JAX package's inclusive test,
    ``ix2 - ix1 >= 0 and iy2 - iy1 >= 0``) is filled with ``fill_in`` with
    probability ``ratio``. One ``rng.rand()`` per ignore box, drawn before
    its overlap test, as there. The rectangles (numpy slices of the
    truncated corners, as the JAX package cuts them) form a host mask that
    reaches the device with the fill through pinned memory; the blank is one
    ``torch.where``, with no host sync."""

    def __init__(self, ratio=0.5, fill_in=(0, 0, 0)):
        self.ratio = ratio
        self.fill_in = fill_in

    def __call__(self, results, rng, pyrng=None):
        ig = results.get("gt_bboxes_ignore")
        if ig is None or len(ig) == 0:
            return results
        gt = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        img = results["img"]
        mask = None
        for i in range(len(ig)):
            if rng.rand() <= self.ratio:
                x1, y1, x2, y2 = ig[i]
                overlaps = any(
                    min(x2, g[2]) - max(x1, g[0]) >= 0
                    and min(y2, g[3]) - max(y1, g[1]) >= 0 for g in gt)
                if not overlaps:
                    if mask is None:
                        mask = np.zeros(img.shape[:2], bool)
                    mask[int(y1):int(y2), int(x1):int(x2)] = True
        if mask is not None:
            fill = torch.tensor(self.fill_in, dtype=img.dtype).expand(
                img.shape[2])
            results["img"] = torch.where(
                to_device(torch.from_numpy(mask), img.device)[..., None],
                to_device(fill.contiguous(), img.device), img)
        return results


@PIPELINES.register
class RandomFlip:
    def __init__(self, flip_ratio=None, direction="horizontal"):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results, rng, pyrng=None):
        if "flip" not in results:
            flip = self.flip_ratio is not None and rng.rand() < self.flip_ratio
            results["flip"] = flip
            results["flip_direction"] = self.direction if flip else None
        if results["flip"]:
            img = results["img"]
            h, w = img.shape[:2]
            horizontal = results["flip_direction"] == "horizontal"
            results["img"] = img.flip(1 if horizontal else 0)
            for key in results.get("bbox_fields", []):
                old = results[key]
                b = old.copy()
                if len(b):
                    if horizontal:
                        b[:, 0], b[:, 2] = w - old[:, 2], w - old[:, 0]
                    else:
                        b[:, 1], b[:, 3] = h - old[:, 3], h - old[:, 1]
                results[key] = b
            for key in results.get("mask_fields", []):
                results[key] = results[key].flip(results["flip_direction"])
            for key in results.get("seg_fields", []):
                results[key] = results[key].flip(1 if horizontal else 0)
        return results


@PIPELINES.register
class Normalize:
    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results, rng, pyrng=None):
        img = results["img"].float()
        if self.to_rgb:
            img = img.flip(-1)
        mean = torch.from_numpy(self.mean).to(img.device)
        std = torch.from_numpy(self.std).to(img.device)
        results["img"] = (img - mean) / std
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register
class Pad:
    """Pad right and bottom to a fixed size or a size divisor."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results, rng, pyrng=None):
        img = results["img"]
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = (h + d - 1) // d * d, (w + d - 1) // d * d
        out = img.new_full((th, tw, *img.shape[2:]), self.pad_val)
        out[:h, :w] = img
        results["img"] = out
        for key in results.get("mask_fields", []):
            results[key] = results[key].pad((th, tw))
        for key in results.get("seg_fields", []):
            seg = results[key]
            padded = seg.new_full((th, tw), 255)
            padded[:seg.shape[0], :seg.shape[1]] = seg
            results[key] = padded
        results["pad_shape"] = tuple(out.shape)
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


@PIPELINES.register
class SegRescale:
    """The semantic maps resized by ``scale_factor`` (OpenCV's
    ``INTER_NEAREST``); HTC's semantic head works at 1/8 of the input."""

    def __init__(self, scale_factor=1.0):
        self.scale_factor = scale_factor

    def __call__(self, results, rng=None, pyrng=None):
        if self.scale_factor == 1:
            return results
        for key in results.get("seg_fields", []):
            seg = results[key]
            nh = int(seg.shape[0] * self.scale_factor + 0.5)
            nw = int(seg.shape[1] * self.scale_factor + 0.5)
            results[key] = resize_nearest(seg, nh, nw)
        return results


@PIPELINES.register
class MultiScaleFlipAug:
    """Test-time wrapper: the inner transforms at each scale (and flipped
    where ``flip``); every key of the result becomes a list."""

    def __init__(self, transforms, img_scale=None, flip=False,
                 flip_direction="horizontal"):
        self.transforms = Compose(transforms)
        self.img_scale = ([tuple(img_scale)] if isinstance(img_scale, tuple)
                          or (isinstance(img_scale, list)
                              and np.isscalar(img_scale[0]))
                          else [tuple(s) for s in (img_scale or [])])
        self.flip = flip
        self.flip_direction = flip_direction

    def __call__(self, results, rng, pyrng=None):
        aug_results = []
        for scale in self.img_scale:
            for f in ([False, True] if self.flip else [False]):
                r = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                     for k, v in results.items()}
                r["scale"] = scale
                r["scale_idx"] = None
                r["flip"] = f
                r["flip_direction"] = self.flip_direction if f else None
                aug_results.append(self.transforms(r, rng, pyrng))
        return {key: [r[key] for r in aug_results] for key in aug_results[0]}
