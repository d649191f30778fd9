"""The port's strong augmentations against Pillow, OpenCV and the JAX package.

Every image op of ``dsl_tpu_torch/data/pipelines/image_ops.py`` is held bit
for bit against the library call the JAX package makes (Pillow 12.1 and
OpenCV 5.0 as installed): ``Image.blend`` over all 65 536 (in1, in2) pairs
at alphas inside and outside [0, 1]; the ``ImageEnhance`` and ``ImageOps``
ops on seeded images of odd sizes; ``convert("L")``, RGB -> HSV, HSV -> RGB
and ``cv2.cvtColor(RGB2GRAY)`` on a seeded sample of 2^16 colours plus the
grey axis and the cube's corners (all 2^24 in the ``slow`` sweep);
``GaussianBlur`` at sigmas across [0.1, 2] on 37x53; ``cv2.warpAffine``
(bilinear, constant border 125) for each of the four affine kinds at many
sizes, and ``cv2.getRotationMatrix2D``. Tolerance: none, every value equal.

``PatchShuffle``, ``RandomAugmentBBox`` (every ``aug_type``),
``RandomAugmentBBox_Fast`` and ``UBAug`` run on the committed decodes of
the JPEG fixtures from ``random.seed(s)`` + ``np.random.seed(s)`` on the
JAX side and ``random.Random(s)`` + ``np.random.RandomState(s)`` on the
port's: images bit-identical, boxes, labels and the ``PS`` keys equal, and
both generators left in the same state. The ``PatchShuffle`` seam test
shows both packages splitting a box that reaches the image's last row. The
flagship's two train pipelines, run through a labeled and an unlabeled
dataset sharing one pair of generators, give the JAX package's images and
boxes sample by sample.
"""

import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from dsl_tpu.data.pipelines import strong_aug as jax_sa
from dsl_tpu.data.pipelines import transforms as jax_tf
from dsl_tpu_torch.data.pipelines import Compose
from dsl_tpu_torch.data.pipelines import image_ops as ops
from dsl_tpu_torch.data.pipelines import strong_aug as sa
from dsl_tpu_torch.data.pipelines import transforms as tf
from torch_port_make_fixtures import FIXTURES, load_decodes

torch.set_num_threads(2)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _pil(a: np.ndarray) -> Image.Image:
    return Image.fromarray(a)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _image(seed: int, hw=(37, 53), low=0, high=256) -> np.ndarray:
    return np.random.RandomState(seed).randint(low, high, (*hw, 3)).astype(np.uint8)


# -- image ops against the libraries ----------------------------------------

@pytest.mark.parametrize("alphas", [
    (0.0, 0.1, 1 / 3, 0.46, 0.5, 0.77, 0.999, 1.0),
    (-0.5, -0.01, 1.001, 1.1, 1.37, 1.54, 1.9, 2.5)], ids=["inside", "outside"])
def test_blend_matches_pillow_on_every_pair(alphas):
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    a3, b3 = np.stack([a] * 3, -1), np.stack([b] * 3, -1)
    for alpha in alphas:
        _equal(ops.blend(_t(a3), _t(b3), alpha),
               Image.blend(_pil(a3), _pil(b3), alpha))


ENHANCE = {"Color": ops.color, "Contrast": ops.contrast,
           "Brightness": ops.brightness, "Sharpness": ops.sharpness}


@pytest.mark.parametrize("name", sorted(ENHANCE))
def test_enhance_matches_pillow(name):
    for img in (_image(0), _image(1, (61, 45), 60, 140), _image(2, (3, 2))):
        for factor in (0.1, 0.46, 1.0, 1.54, 1.9):
            want = getattr(ImageEnhance, name)(_pil(img)).enhance(factor)
            _equal(ENHANCE[name](_t(img), factor), want)


LUT_OPS = {
    "AutoContrast": (lambda t, a: ops.autocontrast(t),
                     lambda p, a: ImageOps.autocontrast(p), [None]),
    "Equalize": (lambda t, a: ops.equalize(t),
                 lambda p, a: ImageOps.equalize(p), [None]),
    "Solarize": (ops.solarize, ImageOps.solarize, [0, 26, 128, 230, 256]),
    "Posterize": (ops.posterize, ImageOps.posterize, [1, 4, 7, 8]),
}


@pytest.mark.parametrize("name", sorted(LUT_OPS))
def test_lut_ops_match_pillow(name):
    port, ref, args = LUT_OPS[name]
    flat = np.full((5, 7, 3), 77, np.uint8)
    for img in (_image(3), _image(4, (61, 45), 60, 140), flat):
        for arg in args:
            _equal(port(_t(img), arg), ref(_pil(img), arg))


def _colours(sample: int | None) -> np.ndarray:
    """A (1, N, 3) row: a seeded sample of ``sample`` colours, the grey axis
    and the cube's corners; every 2^24 colour with None."""
    if sample is None:
        c = np.arange(2 ** 24, dtype=np.uint32)
        rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1)
    else:
        grey = np.repeat(np.arange(256), 3).reshape(-1, 3)
        corners = np.array([[r, g, b] for r in (0, 255) for g in (0, 255)
                            for b in (0, 255)])
        rgb = np.concatenate([np.random.RandomState(5).randint(
            0, 256, (sample, 3)), grey, corners])
    return rgb.astype(np.uint8).reshape(1, -1, 3)


CONVERSIONS = {
    "L": (ops.to_l, lambda a: np.asarray(_pil(a).convert("L"))),
    "HSV": (ops.rgb_to_hsv, lambda a: np.asarray(_pil(a).convert("HSV"))),
    "HSV_to_RGB": (ops.hsv_to_rgb,
                   lambda a: np.asarray(Image.fromarray(a, "HSV").convert("RGB"))),
    "RGB2GRAY": (ops.rgb_to_gray_cv, lambda a: cv2.cvtColor(a, cv2.COLOR_RGB2GRAY)),
}


@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_colour_conversions_match_the_libraries(name):
    port, ref = CONVERSIONS[name]
    colours = _colours(2 ** 16)
    _equal(port(_t(colours)), ref(colours))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_colour_conversions_match_on_every_colour(name):
    port, ref = CONVERSIONS[name]
    colours = _colours(None).reshape(4096, 4096, 3)
    _equal(port(_t(colours)), ref(colours))


def test_hue_shift_matches_pillow():
    img = _image(6)
    for shift in (-25, -1, 0, 3, 25):
        hsv = np.asarray(_pil(img).convert("HSV")).copy()
        hsv[..., 0] = (hsv[..., 0].astype(int) + shift) % 256
        _equal(ops.shift_hue(_t(img), shift),
               Image.fromarray(hsv, "HSV").convert("RGB"))


@pytest.mark.parametrize("sigma", [0.1, 0.37, 0.8, 1.0, 1.45, 2.0])
def test_gaussian_blur_matches_pillow(sigma):
    for img in (_image(7), _image(8, (5, 4))):
        _equal(ops.gaussian_blur(_t(img), sigma),
               _pil(img).filter(ImageFilter.GaussianBlur(radius=sigma)))


@pytest.mark.parametrize("kind", ["tx", "ty", "rotate", "shear"])
def test_warp_affine_matches_cv2(kind):
    """The JAX package's matrices of ``kind`` (weak and strong) at many
    sizes, both sides of OpenCV's 16-column vector blocks."""
    rng = np.random.RandomState(["tx", "ty", "rotate", "shear"].index(kind))
    for h, w in [(1, 1), (7, 15), (16, 16), (29, 17), (45, 33), (97, 131),
                 (240, 320)]:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        lim = (0.05, 0.1) if kind in ("tx", "ty") else (10.0, 30.0)
        strength = rng.uniform(-lim[h % 2], lim[h % 2])
        mat = jax_sa._affine_matrix(kind, h, w, strength)
        port_mat = sa._affine_matrix(kind, h, w, strength)
        assert port_mat.dtype == mat.dtype and np.array_equal(port_mat, mat)
        want = cv2.warpAffine(img, mat, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(125, 125, 125))
        _equal(ops.warp_affine(_t(img), mat, 125), want)


def test_rotation_matrix_matches_cv2():
    rng = np.random.RandomState(9)
    for _ in range(200):
        h, w = rng.randint(1, 1400, 2)
        angle = rng.uniform(-30, 30)
        got = ops.get_rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
        want = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- transforms against the JAX package -----------------------------------

def _results(seed: int) -> dict:
    """A committed fixture decode with 4 GT boxes (labels 0-3) and 2 ignore
    boxes, as the pipeline has them after Resize and flip."""
    name = sorted(FIXTURES)[seed % len(FIXTURES)]
    img = load_decodes()[name]
    h, w = img.shape[:2]
    rng = np.random.RandomState(100 + seed)
    x1, y1 = rng.uniform(0, w * 0.7, 6), rng.uniform(0, h * 0.7, 6)
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, w * 0.3, 6),
                      y1 + rng.uniform(5, h * 0.3, 6)], 1).astype(np.float32)
    return dict(img=img, gt_bboxes=boxes[:4], gt_bboxes_ignore=boxes[4:],
                gt_labels=np.arange(4), img_fields=["img"],
                bbox_fields=["gt_bboxes", "gt_bboxes_ignore"])


def _run(port_t, jax_t, results: dict, seed: int):
    """Both transforms on copies of ``results`` from generators seeded with
    ``seed``; the generators' next draws must agree afterwards."""
    copy = {k: (v.copy() if isinstance(v, (np.ndarray, list)) else v)
            for k, v in results.items()}
    port = dict(copy, img=_t(results["img"]))
    random.seed(seed)
    np.random.seed(seed)
    ref = jax_t(copy)
    rng, pyrng = np.random.RandomState(seed), random.Random(seed)
    port = port_t(port, rng, pyrng)
    assert rng.rand() == np.random.rand() and pyrng.random() == random.random()
    _equal(port["img"], ref["img"])
    for key in ("gt_bboxes", "gt_bboxes_ignore", "gt_labels", "PS",
                "PS_place", "PS_mode"):
        assert (key in port) == (key in ref), key
        if key in ref:
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    return port, ref


@pytest.mark.parametrize("seed", range(6))
def test_patch_shuffle_matches_jax(seed):
    cfg = dict(ratio=0.5, ranges=[0.0, 1.0], mode=["flip", "flop"])
    _run(tf.PatchShuffle(**cfg), jax_tf.PatchShuffle(**cfg), _results(seed),
         seed)


def test_patch_shuffle_splits_a_box_on_the_last_row_as_jax():
    """The reference's seam test also holds y against the full height in
    'flip' mode: a box reaching y2 = h is split in two, one of them
    inverted; a box ending above the last row moves whole."""
    img = np.random.RandomState(0).randint(0, 256, (100, 200, 3)).astype(np.uint8)
    results = dict(img=img, gt_labels=np.array([3, 4]),
                   gt_bboxes=np.array([[10, 20, 30, 100], [10, 20, 30, 90]],
                                      np.float32),
                   bbox_fields=["gt_bboxes"])
    cfg = dict(ratio=1.0, ranges=[0.5, 0.5], mode=["flip"])
    port, _ = _run(tf.PatchShuffle(**cfg), jax_tf.PatchShuffle(**cfg),
                   results, 0)
    np.testing.assert_array_equal(port["gt_bboxes"], [
        [110, 20, 199, 100], [0, 20, -70, 100], [110, 20, 130, 90]])
    assert port["gt_labels"].tolist() == [3, 3, 4]


AUG_TYPES = ["strong", "strong++", "default", "color", "affine", "cutout",
             "color_only", "except_affine"]


@pytest.mark.parametrize("aug_type", AUG_TYPES)
def test_random_augment_bbox_matches_jax(aug_type):
    for seed in range(3):
        for port_cls, jax_cls in ((sa.RandomAugmentBBox, jax_sa.RandomAugmentBBox),
                                  (sa.RandomAugmentBBoxFast,
                                   jax_sa.RandomAugmentBBoxFast)):
            _run(port_cls(aug_type=aug_type), jax_cls(aug_type=aug_type),
                 _results(seed), seed)


def test_every_colour_policy_op_matches_jax():
    img = load_decodes()[sorted(FIXTURES)[0]][:96, :128]
    for name in sa.RANDOM_COLOR_POLICY_OPS:
        for magnitude in (1, 5, 9):
            np.random.seed(0)
            want = jax_sa.apply_color_policy(img, name, 1.0, magnitude)
            got = sa.apply_color_policy(_t(img), name, 1.0, magnitude,
                                        np.random.RandomState(0))
            _equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_ubaug_matches_jax(seed):
    _run(sa.UBAug(), jax_sa.UBAug(), _results(seed), seed)


def test_compose_builds_the_flagship_train_pipelines():
    from dsl_tpu_torch.config import Config

    cfg = Config.fromfile(str(Path(__file__).resolve().parent.parent / "configs"
                              / "fcos_semi" / "RLA_r50_fcos_semi_dsl.py"))
    for key in ("train", "unlabel_train"):
        names = repr(Compose(cfg.data[key]["pipeline"]))
        assert "PatchShuffle" in names
    assert "UBAug" in repr(Compose(cfg.data["unlabel_train"]["pipeline"]))


def test_datasets_draw_as_jax_through_the_flagship_pipelines(tmp_path):
    """The flagship's two train pipelines (strong augmentations included,
    up to ``Normalize``) through a labeled and an unlabeled dataset that
    share one pair of generators, sample by sample in a loader's order:
    every image bit-identical to the JAX package's and every box equal, so
    the two generators reach each transform in the JAX package's order.
    The 640-wide fixtures at ``Resize`` (640, 480) keep their size, so both
    resizes copy the decoded pixels."""
    from dsl_tpu.data import datasets as jax_datasets  # noqa: F401
    from dsl_tpu.registry import DATASETS as JAX_DATASETS
    from dsl_tpu.registry import build_from_cfg as jax_build
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.data import datasets  # noqa: F401
    from dsl_tpu_torch.registry import DATASETS, build_from_cfg
    from dsl_tpu_torch.utils import synthetic_data
    from torch_port_make_fixtures import OUT

    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()
               if w == 640]
    paths = synthetic_data.make_semicoco_dir(tmp_path, sources, 3, 4)
    cfg = Config.fromfile(str(Path(__file__).resolve().parent.parent / "configs"
                              / "fcos_semi" / "RLA_r50_fcos_semi_dsl.py"))
    data = synthetic_data.semi_config(cfg._cfg_dict, paths)["data"]
    cfgs = []
    for key in ("train", "unlabel_train"):
        pipeline = [dict(t) for t in data[key]["pipeline"]]
        pipeline = pipeline[:[t["type"] for t in pipeline].index("Normalize")]
        next(t for t in pipeline if t["type"] == "Resize").update(
            img_scale=(640, 480))
        cfgs.append({**data[key], "pipeline": pipeline, "thres": None})
    random.seed(3)
    np.random.seed(3)
    want_ds = [jax_build(dict(c), JAX_DATASETS) for c in cfgs]
    rng, pyrng = np.random.RandomState(3), random.Random(3)
    got_ds = [build_from_cfg({**c, "device": "cpu", "rng": rng, "pyrng": pyrng},
                             DATASETS) for c in cfgs]
    order = [(0, 0), (1, 0), (1, 1), (0, 1), (1, 2), (1, 3), (0, 2)] * 2
    for k, i in order:
        want, got = want_ds[k][i], got_ds[k][i]
        _equal(got["img"], want["img"])
        for key in ("gt_bboxes", "gt_bboxes_ignore", "gt_labels", "PS_mode",
                    "flip"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
