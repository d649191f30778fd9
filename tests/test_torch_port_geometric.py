"""The port's geometric and photometric AutoAugment transforms against the
JAX package's classes and the OpenCV calls they make.

- ``Shear`` (both directions), ``Rotate``, ``Translate`` (both directions,
  a per-channel fill), ``ColorTransform``, ``EqualizeTransform``,
  ``BrightnessTransform`` and ``ContrastTransform`` on crops of the
  committed JPEG decodes with GT and ignore boxes, 16 seeds each
  (``np.random.seed(s)`` for JAX, ``RandomState(s)`` for the port): images
  bit-identical, boxes and labels equal, both generators left alike;
- the mmcv ops on seeded images of odd sizes: ``imshear``,
  ``imtranslate`` and ``imrotate`` against ``cv2.warpAffine`` with a
  per-channel border; ``adjust_color``, ``adjust_brightness`` and
  ``adjust_contrast`` against the JAX helpers (``cv2.addWeighted`` on
  float32, ``np.histogram``, Python's ``round``), ``imequalize`` against
  JAX's; ``image_ops.add_weighted`` against ``cv2.addWeighted`` on float32
  arrays of every length from 1 to 70 and on odd image widths;
- a mask field raises, naming it; a float image raises ``TypeError``.

Tolerance: none, every value equal.
"""

import functools

import cv2
import numpy as np
import pytest
import torch

from dsl_tpu.data.pipelines import geometric as jg
from dsl_tpu_torch.data.pipelines import geometric as g
from dsl_tpu_torch.data.pipelines import image_ops as ops
from test_torch_port_extra_transforms import assert_same, results_for, run_both

torch.set_num_threads(2)


def _image(seed: int, hw) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3)).astype(np.uint8)


CASES = {
    "Shear": dict(level=7, prob=0.8),
    "Shear_vertical": dict(level=4, prob=0.8, direction="vertical",
                           img_fill_val=(1, 90, 250)),
    "Rotate": dict(level=6, prob=0.8),
    "Rotate_scaled": dict(level=9, prob=0.9, scale=0.8, center=(40.5, 30.0),
                          img_fill_val=7),
    "Translate": dict(level=2, prob=0.8, img_fill_val=(10, 20, 30)),
    "Translate_vertical": dict(level=3, prob=0.8, direction="vertical",
                               min_size=4),
    "ColorTransform": dict(level=8, prob=0.8),
    "EqualizeTransform": dict(prob=0.8),
    "BrightnessTransform": dict(level=3, prob=0.8),
    "ContrastTransform": dict(level=9, prob=0.8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax(case):
    name = case.split("_")[0]
    port_t = getattr(g, name)(**CASES[case])
    jax_t = getattr(jg, name)(**CASES[case])
    changed = 0
    for seed in range(16):
        before = results_for(seed)
        port, ref = run_both(port_t, jax_t, before, seed)
        assert_same(port, ref)
        changed += not np.array_equal(ref["img"], before["img"])
    assert changed


@pytest.mark.parametrize("hw", [(37, 53), (64, 97), (21, 16)])
def test_warps_are_cv2(hw):
    img = _image(hw[0], hw)
    fills = (0, (128, 128, 128), (5, 200, 77))
    for i, fill in enumerate(fills):
        for d in ("horizontal", "vertical"):
            for want, got in (
                    (jg.imshear(img, 0.37 - 0.3 * i, d, fill),
                     g.imshear(torch.from_numpy(img), 0.37 - 0.3 * i, d, fill)),
                    (jg.imtranslate(img, 11 - 9 * i, d, fill),
                     g.imtranslate(torch.from_numpy(img), 11 - 9 * i, d, fill))):
                np.testing.assert_array_equal(got.numpy(), want)
        for angle in (13.0, -27.5, 90.0):
            np.testing.assert_array_equal(
                g.imrotate(torch.from_numpy(img), angle, None, 1.1, fill).numpy(),
                jg.imrotate(img, angle, None, 1.1, fill))


@pytest.mark.parametrize("hw", [(37, 53), (1, 5), (2, 3), (45, 81)])
def test_photometric_ops_are_jax(hw):
    img = _image(7 + hw[1], hw)
    t = torch.from_numpy(img)
    for factor in (0.1, 0.73, 1.0, 1.55, 1.9):
        np.testing.assert_array_equal(g.adjust_color(t, factor).numpy(),
                                      jg.adjust_color(img, factor))
        np.testing.assert_array_equal(g.adjust_brightness(t, factor).numpy(),
                                      jg.adjust_brightness(img, factor))
        np.testing.assert_array_equal(g.adjust_contrast(t, factor).numpy(),
                                      jg.adjust_contrast(img, factor))
    np.testing.assert_array_equal(g.adjust_color(t, 0.6, 0.3, 12.5).numpy(),
                                  jg.adjust_color(img, 0.6, 0.3, 12.5))
    np.testing.assert_array_equal(g.imequalize(t).numpy(), jg.imequalize(img))
    flat = np.full((*hw, 3), 9, np.uint8)
    np.testing.assert_array_equal(g.imequalize(torch.from_numpy(flat)).numpy(),
                                  jg.imequalize(flat))


def test_contrast_mean_rounds_half_to_even():
    """A gray mean of exactly k + 0.5 rounds to the even level, as Python's
    ``round`` does."""
    img = np.zeros((2, 2, 3), np.uint8)
    for pair in ((10, 11), (11, 12)):
        img[0, :], img[1, :] = pair[0], pair[1]   # mean k + 0.5
        np.testing.assert_array_equal(
            g.adjust_contrast(torch.from_numpy(img), 0.4).numpy(),
            jg.adjust_contrast(img, 0.4))


@functools.lru_cache(maxsize=1)
def _weights():
    rng = np.random.RandomState(3)
    return [(0.3718, 1 - 0.3718, 0.0), (1.7, -0.7, 0.0),
            (float(rng.rand()), float(rng.rand()), 3.7)]


@pytest.mark.parametrize("n", list(range(1, 71)) + [3 * 37 * 53])
def test_add_weighted_is_cv2(n):
    rng = np.random.RandomState(n)
    a = (rng.rand(1, n) * 255).astype(np.float32)
    b = (rng.rand(1, n) * 255).astype(np.float32)
    for alpha, beta, gamma in _weights():
        np.testing.assert_array_equal(
            ops.add_weighted(torch.from_numpy(a), alpha, torch.from_numpy(b),
                             beta, gamma).numpy(),
            cv2.addWeighted(a, alpha, b, beta, gamma), err_msg=f"n {n}")


def test_masks_and_floats_raise():
    r = results_for(0)
    r["img"] = torch.from_numpy(r["img"])
    r["mask_fields"] = ["gt_masks"]
    with pytest.raises(NotImplementedError, match="mask_fields"):
        g.Shear(level=3, prob=1.0)(r, np.random.RandomState(0))
    with pytest.raises(TypeError, match="uint8"):
        g.imrotate(torch.zeros((4, 4, 3)), 10.0)
