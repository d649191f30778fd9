"""The port's mmdet extra transforms against the JAX package's classes.

``RandomCrop``, ``MinIoURandomCrop``, ``Expand``, ``PhotoMetricDistortion``,
``CutOut``, ``RandomShift`` and ``AutoAugment`` (of geometric and colour
policies) run on crops of the committed decodes of the JPEG fixtures (odd
sizes) with GT and ignore boxes, from ``np.random.seed(s)`` on the JAX side
and ``np.random.RandomState(s)`` on the port's, for 16 seeds each. Images
(uint8, or float32 after ``PhotoMetricDistortion``) bit-identical, boxes,
labels and ``img_shape`` equal, a ``None`` from both alike, and both
generators left in the same state. Tolerance: none.

OpenCV's uint8 HSV conversions, which ``PhotoMetricDistortion`` runs, are
held exhaustively against ``cv2.cvtColor``: ``COLOR_BGR2HSV`` on all 2^24
BGR triples and ``COLOR_HSV2BGR`` on all 2^24 (H, S, V) triples (H past 179
too, which the hue shift's rounding can reach; ``slow``), the latter in
rows of 4096 pixels (OpenCV's vector blocks) and of 16 (its scalar code);
in Tier-1 its 180 x 256 x 256 triples of OpenCV's H range in rows of 4096,
and seeded rows of every width from 1 to 80.
"""

import functools

import cv2
import numpy as np
import pytest
import torch

from dsl_tpu.data.pipelines import extra_transforms as jax_et
from dsl_tpu_torch.data.pipelines import Compose
from dsl_tpu_torch.data.pipelines import extra_transforms as et
from dsl_tpu_torch.data.pipelines import image_ops as ops
from torch_port_make_fixtures import FIXTURES, load_decodes

torch.set_num_threads(2)

SEEDS = range(16)
DECODES = functools.lru_cache(maxsize=1)(load_decodes)


def results_for(seed: int, hw=(91, 133)) -> dict:
    """A crop of a fixture decode with 4 GT boxes and 2 ignore boxes."""
    name = sorted(FIXTURES)[seed % len(FIXTURES)]
    h, w = hw
    img = DECODES()[name][37:37 + h, 51:51 + w].copy()
    rng = np.random.RandomState(1000 + seed)
    x1, y1 = rng.uniform(0, w * 0.7, 6), rng.uniform(0, h * 0.7, 6)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(4, w / 2, 6), w),
                      np.minimum(y1 + rng.uniform(4, h / 2, 6), h)],
                     1).astype(np.float32)
    return dict(img=img, img_shape=img.shape, gt_bboxes=boxes[:4],
                gt_labels=np.arange(4, dtype=np.int64) + 1,
                gt_bboxes_ignore=boxes[4:],
                bbox_fields=["gt_bboxes", "gt_bboxes_ignore"])


def run_both(port_t, jax_t, results, seed):
    port = {k: (v.copy() if isinstance(v, (np.ndarray, list)) else v)
            for k, v in results.items()}
    port["img"] = torch.from_numpy(results["img"].copy())
    ref = {k: (v.copy() if isinstance(v, (np.ndarray, list)) else v)
           for k, v in results.items()}
    np.random.seed(seed)
    ref = jax_t(ref)
    rng = np.random.RandomState(seed)
    port = port_t(port, rng, None)
    assert rng.rand() == np.random.rand(), "the generators parted"
    return port, ref


def assert_same(port, ref):
    assert (port is None) == (ref is None)
    if ref is None:
        return
    got = port["img"].numpy()
    assert got.dtype == ref["img"].dtype and got.shape == ref["img"].shape
    np.testing.assert_array_equal(got, ref["img"])
    for key in ("gt_bboxes", "gt_bboxes_ignore", "gt_labels"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
        assert port[key].dtype == ref[key].dtype, key
    assert tuple(port["img_shape"]) == tuple(ref["img_shape"])


POLICIES = [
    [dict(type="Shear", level=6, prob=0.9)],
    [dict(type="Rotate", level=4, prob=0.8),
     dict(type="ColorTransform", level=7, prob=0.7)],
    [dict(type="Translate", level=3, prob=0.9, img_fill_val=(10, 20, 30)),
     dict(type="EqualizeTransform", prob=0.6)],
    [dict(type="BrightnessTransform", level=8, prob=0.8),
     dict(type="ContrastTransform", level=2, prob=0.8)],
]

CASES = {
    "RandomCrop": dict(crop_size=(64, 80)),
    "RandomCrop_negative": dict(crop_size=(20, 24), allow_negative_crop=True),
    "MinIoURandomCrop": dict(),
    "Expand": dict(mean=(123.675, 116.28, 103.53), ratio_range=(1, 3),
                   prob=0.7),
    "PhotoMetricDistortion": dict(),
    "CutOut": dict(n_holes=(1, 4), cutout_ratio=[(0.1, 0.2), (0.3, 0.15)],
                   fill_in=(7, 8, 250)),
    "CutOut_shape": dict(n_holes=2, cutout_shape=[(10, 12), (30, 5)]),
    "RandomShift": dict(shift_ratio=0.8, max_shift_px=40, filter_thr_px=3),
    "AutoAugment": dict(policies=POLICIES),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax(case):
    name = case.split("_")[0]
    port_t = getattr(et, name)(**CASES[case])
    jax_t = getattr(jax_et, name)(**CASES[case])
    changed = 0
    for seed in SEEDS:
        before = results_for(seed)
        port, ref = run_both(port_t, jax_t, before, seed)
        assert_same(port, ref)
        changed += ref is not None and (ref["img"].shape != before["img"].shape
                                        or not np.array_equal(ref["img"],
                                                              before["img"]))
    assert changed


def test_transforms_build_through_compose():
    pipe = Compose([dict(type=name.split("_")[0], **cfg)
                    for name, cfg in CASES.items()
                    if name in ("Expand", "RandomShift", "AutoAugment")])
    assert [type(t).__name__ for t in pipe.transforms] == [
        "Expand", "RandomShift", "AutoAugment"]
    assert [type(t).__name__ for t in pipe.transforms[2].policies[1].transforms
            ] == ["Rotate", "ColorTransform"]


def _all_triples() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


def test_bgr_to_hsv_is_cv2_on_every_colour():
    bgr = _all_triples()
    np.testing.assert_array_equal(ops.bgr_to_hsv_cv(torch.from_numpy(bgr)).numpy(),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_is_cv2_on_every_hsv_triple():
    """The 180 x 256 x 256 triples of OpenCV's H range, in rows of 4096."""
    hsv = _all_triples()[:180 * 16].reshape(-1, 4096, 3)
    np.testing.assert_array_equal(ops.hsv_to_bgr_cv(torch.from_numpy(hsv)).numpy(),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.slow
@pytest.mark.parametrize("width", [4096, 16])
def test_hsv_to_bgr_is_cv2_on_every_byte_triple(width):
    hsv = _all_triples().reshape(-1, width, 3)
    np.testing.assert_array_equal(ops.hsv_to_bgr_cv(torch.from_numpy(hsv)).numpy(),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_hsv_to_bgr_is_cv2_at_every_width():
    rng = np.random.RandomState(4)
    for width in range(1, 81):
        hsv = rng.randint(0, 256, (9, width, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            ops.hsv_to_bgr_cv(torch.from_numpy(hsv)).numpy(),
            cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR), err_msg=f"width {width}")
