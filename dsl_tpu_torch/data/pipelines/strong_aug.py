"""Strong augmentations: STAC's RandomAugmentBBox and unbiased-teacher UBAug.

Counterpart of ``dsl_tpu/data/pipelines/strong_aug.py``. The image is a
uint8 (H, W, 3) tensor on its device and every Pillow and OpenCV call of
the JAX package is its bit-exact counterpart in :mod:`image_ops`; boxes
stay host numpy arrays and are mapped by the JAX package's numpy code.
Random draws take the JAX package's order of calls: ``rng`` (an
``np.random.RandomState``) for its ``np.random`` calls and ``pyrng`` (a
``random.Random``) for its calls of Python's ``random``. Random fill values
are drawn on the host and reach the device through pinned memory, so no
transform waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from dsl_tpu_torch.data.pipelines import image_ops as ops
from dsl_tpu_torch.registry import PIPELINES
from dsl_tpu_torch.utils.device import to_device

# -- RandAug colour bank, magnitude in [1, 10] --------------------------------


def _enhance_factor(magnitude: int) -> float:
    return 0.1 + (magnitude / 10.0) * 1.8


COLOR_OPS = {
    "Identity": lambda img, m: img,
    "AutoContrast": lambda img, m: ops.autocontrast(img),
    "Equalize": lambda img, m: ops.equalize(img),
    "Solarize": lambda img, m: ops.solarize(img, int(256 - (m / 10.0) * 256)),
    "Color": lambda img, m: ops.color(img, _enhance_factor(m)),
    "Contrast": lambda img, m: ops.contrast(img, _enhance_factor(m)),
    "Brightness": lambda img, m: ops.brightness(img, _enhance_factor(m)),
    "Sharpness": lambda img, m: ops.sharpness(img, _enhance_factor(m)),
    "Posterize": lambda img, m: ops.posterize(
        img, max(1, 8 - int((m / 10.0) * 4))),
}
RANDOM_COLOR_POLICY_OPS = tuple(COLOR_OPS)


def apply_color_policy(img, op_name: str, prob: float, magnitude: int, rng):
    if rng.rand() > prob:
        return img
    return COLOR_OPS[op_name](img, magnitude)


# -- affine: one of translateX / translateY / rotate / shear, cval 125 -------


def _affine_matrix(kind: str, h: int, w: int, strength: float) -> np.ndarray:
    if kind == "tx":
        return np.float32([[1, 0, strength * w], [0, 1, 0]])
    if kind == "ty":
        return np.float32([[1, 0, 0], [0, 1, strength * h]])
    if kind == "rotate":
        return ops.get_rotation_matrix_2d((w / 2, h / 2), strength, 1.0)
    if kind == "shear":
        s = np.tan(np.deg2rad(strength))
        return np.float32([[1, s, -s * h / 2], [0, 1, 0]])
    raise ValueError(kind)


def random_affine(img, boxes, rng, pyrng, weak: bool = False, cval: int = 125):
    """Global affine on the image and its boxes (through their 4 corners)."""
    h, w = img.shape[:2]
    kind = pyrng.choice(["tx", "ty", "rotate", "shear"])
    if kind in ("tx", "ty"):
        lim = 0.05 if weak else 0.1
    else:
        lim = 10.0 if weak else 30.0
    strength = rng.uniform(-lim, lim)
    mat = _affine_matrix(kind, h, w, strength)
    out = ops.warp_affine(img, mat, cval)
    if boxes is not None and len(boxes):
        corners = np.stack([
            boxes[:, [0, 1]], boxes[:, [2, 1]],
            boxes[:, [0, 3]], boxes[:, [2, 3]]], axis=1)       # (N, 4, 2)
        ones = np.ones((*corners.shape[:2], 1), np.float32)
        pts = np.concatenate([corners, ones], axis=-1) @ mat.T  # (N, 4, 2)
        boxes = np.concatenate(
            [pts.min(axis=1), pts.max(axis=1)], axis=-1).astype(np.float32)
    return out, boxes


def cutout(img, rng, n_range=(1, 5), size_frac=0.2, fill: int = 128):
    """1..5 square grey patches, side up to ``size_frac`` of min(H, W)."""
    h, w = img.shape[:2]
    out = img.clone()
    for _ in range(rng.randint(n_range[0], n_range[1] + 1)):
        side = int(rng.uniform(0, size_frac) * min(h, w))
        if side < 1:
            continue
        cy = rng.randint(0, h)
        cx = rng.randint(0, w)
        y1, y2 = max(0, cy - side // 2), min(h, cy + side // 2)
        x1, x2 = max(0, cx - side // 2), min(w, cx + side // 2)
        out[y1:y2, x1:x2] = fill
    return out


def _remove_empty_boxes(boxes: np.ndarray, labels: np.ndarray):
    if len(boxes) == 0:
        return boxes, labels
    keep = (boxes[:, 2] - boxes[:, 0] > 1) & (boxes[:, 3] - boxes[:, 1] > 1)
    return boxes[keep], labels[keep]


@PIPELINES.register
class RandomAugmentBBox:
    """STAC strong augmentation; ``aug_type`` picks the layers: strong,
    strong++, default, color, affine, cutout, color_only, except_affine."""

    LAYERS = {
        "strong": ["color", "affine_or_inbox", "cutout"],
        "strong++": ["color", "affine_or_inbox", "jitter", "cutout"],
        "default": [],
        "color": ["color", "cutout"],
        "affine": ["affine_or_inbox"],
        "cutout": ["cutout"],
        "color_only": ["color"],
        "except_affine": ["color", "affine_global", "cutout"],
    }

    def __init__(self, aug_type="strong", magnitude=10,
                 weighted_inbox_selection=False):
        if aug_type not in self.LAYERS:
            raise NotImplementedError(f"aug_type {aug_type}")
        self.aug_type = aug_type
        self.magnitude = magnitude
        self.weighted_inbox_selection = weighted_inbox_selection
        self.layers = self.LAYERS[aug_type]

    def _color(self, img, boxes, labels, rng, pyrng):
        op = rng.choice(RANDOM_COLOR_POLICY_OPS)
        mag = rng.randint(1, self.magnitude)
        return apply_color_policy(img, op, 1.0, mag, rng), boxes, labels

    def _affine_or_inbox(self, img, boxes, labels, rng, pyrng):
        if len(boxes) and rng.rand() < 0.5:
            return self._inbox_affine(img, boxes, labels, rng, pyrng)
        return self._affine_global(img, boxes, labels, rng, pyrng)

    def _affine_global(self, img, boxes, labels, rng, pyrng):
        img, boxes = random_affine(img, boxes, rng, pyrng, weak=False)
        return img, boxes, labels

    def _inbox_affine(self, img, boxes, labels, rng, pyrng):
        """A weak affine of the crop of one box (area-weighted choice
        optional)."""
        if self.weighted_inbox_selection:
            areas = np.maximum(
                (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1)
            k = rng.choice(len(boxes), p=areas / areas.sum())
        else:
            k = rng.randint(len(boxes))
        x1, y1, x2, y2 = boxes[k].astype(int)
        x1, y1 = max(0, x1), max(0, y1)
        crop = img[y1:y2, x1:x2]
        if crop.numel():
            warped, _ = random_affine(crop, None, rng, pyrng, weak=True)
            img = img.clone()
            img[y1:y2, x1:x2] = warped
        return img, boxes, labels

    def _cutout(self, img, boxes, labels, rng, pyrng):
        return cutout(img, rng, (1, 5), 0.2), boxes, labels

    def _jitter(self, img, boxes, labels, rng, pyrng):
        return color_jitter(img, rng), boxes, labels

    def __call__(self, results, rng, pyrng):
        img = results["img"]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32)).copy()
        labels = results.get("gt_labels", np.zeros((0,), np.int64)).copy()
        fns = {"color": self._color, "affine_or_inbox": self._affine_or_inbox,
               "affine_global": self._affine_global, "cutout": self._cutout,
               "jitter": self._jitter}
        # random layer order, cutout always last
        head = [n for n in self.layers if n != "cutout"]
        tail = [n for n in self.layers if n == "cutout"]
        rng.shuffle(head)
        for name in head + tail:
            img, boxes, labels = fns[name](img, boxes, labels, rng, pyrng)
        h, w = img.shape[:2]
        if len(boxes):
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
            boxes, labels = _remove_empty_boxes(boxes, labels)
        results["img"] = img
        results["gt_bboxes"] = boxes.reshape(-1, 4).astype(np.float32)
        results["gt_labels"] = labels
        return results


@PIPELINES.register(name="RandomAugmentBBox_Fast")
class RandomAugmentBBoxFast(RandomAugmentBBox):
    """The reference's _Fast variant differs only in its colour ops' inner
    loop; one implementation serves both names, as in the JAX package."""


# -- UBAug ----------------------------------------------------------------


def color_jitter(img, rng, brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.1):
    """torchvision ColorJitter semantics: factors drawn, then the ops in a
    random order."""
    steps = []
    if brightness:
        f = rng.uniform(1 - brightness, 1 + brightness)
        steps.append(lambda x, f=f: ops.brightness(x, f))
    if contrast:
        f2 = rng.uniform(1 - contrast, 1 + contrast)
        steps.append(lambda x, f=f2: ops.contrast(x, f))
    if saturation:
        f3 = rng.uniform(1 - saturation, 1 + saturation)
        steps.append(lambda x, f=f3: ops.color(x, f))
    if hue:
        shift = rng.uniform(-hue, hue)
        steps.append(lambda x, s=int(shift * 255): ops.shift_hue(x, s))
    rng.shuffle(steps)
    for step in steps:
        img = step(img)
    return img


def random_erase(img, p: float, scale, ratio, rng):
    """torchvision RandomErasing with ``value='random'``."""
    if rng.rand() > p:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        r = np.exp(log_r)
        eh = int(round(np.sqrt(target * r)))
        ew = int(round(np.sqrt(target / r)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            i = rng.randint(0, h - eh + 1)
            j = rng.randint(0, w - ew + 1)
            fill = rng.randint(0, 256, (eh, ew, img.shape[2]), dtype=np.uint8)
            img = img.clone()
            img[i:i + eh, j:j + ew] = to_device(torch.from_numpy(fill),
                                                img.device)
            return img
    return img


@PIPELINES.register
class UBAug:
    """Unbiased-teacher colour augmentation: jitter (p 0.8), grey (p 0.2),
    Gaussian blur with sigma in [0.1, 2] (p 0.5), then three random
    erasures (p 0.7, 0.5, 0.3)."""

    def __call__(self, results, rng, pyrng=None):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            if img.dtype != torch.uint8:
                img = img.clamp(0, 255).to(torch.uint8)
            if rng.rand() < 0.8:
                img = color_jitter(img, rng)
            if rng.rand() < 0.2:
                img = ops.rgb_to_gray_cv(img)[..., None].expand_as(img)
            if rng.rand() < 0.5:
                img = ops.gaussian_blur(img, rng.uniform(0.1, 2.0))
            img = random_erase(img, 0.7, (0.05, 0.2), (0.3, 3.3), rng)
            img = random_erase(img, 0.5, (0.02, 0.2), (0.1, 6.0), rng)
            img = random_erase(img, 0.3, (0.02, 0.2), (0.05, 8.0), rng)
            results[key] = img.contiguous()
        return results
