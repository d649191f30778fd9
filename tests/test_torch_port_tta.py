"""The port's test-time augmentation against the JAX package's, on the CPU.

- the port's numpy NMS keeps exactly what the JAX package's does (a
  ``max_keep`` prefix of it); ``_multiclass_nms_np`` (class by class,
  each stopping at ``max_per_img``) and ``merge_aug_detections`` on seeded
  arrays: exactly the JAX functions' output, with and without centerness
  factors, for a cap the classes reach and one they do not, and for no
  candidates;
- ``read_resized(flip=True)`` mirrors before the resize: equal to
  ``cv2.resize`` of the mirrored decode (the other order is not, at the
  test scale);
- ``single_device_test(flip=True)``, ``tta_test`` and ``tta_test_dense``
  on the tiny flagship over two images (stored losslessly, resized from
  their own sizes to the 64x96 scale): per image the JAX function's
  detections, paired by label, boxes within 1e-4 px and scores within
  1e-4; ``tta_test_dense`` runs no device NMS and refuses a head that is
  not FCOS's.
"""

import json
import types

import cv2
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.apis import test as jax_test
from dsl_tpu.data import datasets as jax_datasets  # noqa: F401 (registers)
from dsl_tpu.registry import DATASETS as JAX_DATASETS
from dsl_tpu.registry import build_from_cfg as jax_build
from dsl_tpu.train import label_store as jax_store
from dsl_tpu_torch.apis import test as port_test
from dsl_tpu_torch.data.pipelines.transforms import read_resized
from dsl_tpu_torch.models.dense_heads import fcos_head
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.train import label_store
from dsl_tpu_torch.utils import synthetic_data
from torch_port_make_fixtures import OUT, load_decodes

torch.set_num_threads(2)

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
PIPELINE = [dict(type="LoadImageFromFile")]
SCALE, CANVAS = (96, 64), (64, 96)
SIZES = ((75, 110), (90, 60))          # (h, w) of the two test images


def _dets(rng, n, scale=80.0):
    xy = rng.uniform(0, scale, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (n, 2))], 1)
    return np.concatenate([boxes, rng.uniform(0, 1, (n, 1))], 1).astype(
        np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_numpy_nms_is_jax(seed):
    """The port's greedy NMS (each kept box against the later boxes still
    alive) keeps what the JAX package's does; ``max_keep`` stops it at a
    prefix of those keeps."""
    rng = np.random.RandomState(seed)
    dets = _dets(rng, 400)
    dets[:200:2, 4] = dets[1:200:2, 4]                 # tied scores
    for thr, floor in ((0.6, 0.0), (0.3, 0.2), (0.9, 0.5)):
        want = jax_store.numpy_nms(dets[:, :4], dets[:, 4], thr, floor)
        got = label_store.numpy_nms(dets[:, :4], dets[:, 4], thr, floor)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(label_store.numpy_nms(
            dets[:, :4], dets[:, 4], thr, floor, max_keep=7), want[:7])


@pytest.mark.parametrize("top", [100, 5])
@pytest.mark.parametrize("factors", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_multiclass_nms_np_is_jax(seed, factors, top):
    rng = np.random.RandomState(seed)
    boxes = _dets(rng, 300)[:, :4]
    scores = rng.uniform(0, 0.3, (300, 6)).astype(np.float32)
    cent = rng.uniform(0, 1, 300).astype(np.float32) if factors else None
    args = (boxes, scores, cent, 0.05, 0.6, top)
    got, want = port_test._multiclass_nms_np(*args), jax_test._multiclass_nms_np(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert 0 < len(got[0]) <= top
    empty = port_test._multiclass_nms_np(boxes, scores * 0, cent, 0.05, 0.6, 100)
    assert empty[0].shape == (0, 5) and empty[1].shape == (0,)


@pytest.mark.parametrize("seed", range(3))
def test_merge_aug_detections_is_jax(seed):
    rng = np.random.RandomState(seed)
    base = _dets(rng, 60)
    per_aug = []
    for _ in range(4):
        d = base.copy()
        d[:, :4] += rng.normal(0, 2, (60, 4))
        d[:, 4] = rng.uniform(0, 1, 60)
        per_aug.append((d.astype(np.float32), rng.randint(0, 5, 60)))
    for thr, top in ((0.5, 100), (0.3, 40)):
        got = port_test.merge_aug_detections(per_aug, thr, top)
        want = jax_test.merge_aug_detections(per_aug, thr, top)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    none = [(np.zeros((0, 5), np.float32), np.zeros((0,), np.int64))] * 2
    assert [len(x) for x in port_test.merge_aug_detections(none)] == [0, 0]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Two crops of the fixture decodes, stored as PNG, and a COCO file."""
    root = tmp_path_factory.mktemp("tta")
    decodes = load_decodes()
    imgs = []
    for i, ((h, w), name) in enumerate(zip(SIZES, ("coco_640x480", "coco_500x375"))):
        cv2.imwrite(str(root / f"img_{i}.png"), decodes[name][40:40 + h, 60:60 + w])
        imgs.append(dict(id=i + 1, file_name=f"img_{i}.png", height=h, width=w))
    cats = [dict(id=i + 1, name=c) for i, c in enumerate(synthetic_data.COCO_CLASSES)]
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=imgs, annotations=[], categories=cats)))
    return ann, root


def test_flip_comes_before_the_resize():
    """At the test scale a 640x480 fixture is resized to 1067x800, where
    mirroring after the resize parts from mirroring before it."""
    path = OUT / "coco_640x480.jpg"
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got, shape, sf = read_resized(path, (1333, 800), "cpu", flip=True)
    want = cv2.resize(np.ascontiguousarray(img[:, ::-1]), (1067, 800),
                      interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got.numpy(), want)
    other = cv2.resize(img, (1067, 800), interpolation=cv2.INTER_LINEAR)[:, ::-1]
    assert not np.array_equal(want, other)
    assert shape == [800, 1067] and sf == [1067 / 640, 800 / 480] * 2


@pytest.fixture(scope="module")
def models(images):
    ann, root = images
    det, variables = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    port = U.port_detector(U.TINY_CFG, variables)
    cfg = dict(type="CocoDataset", ann_file=str(ann), img_prefix=str(root),
               pipeline=PIPELINE, test_mode=True, filter_empty_gt=False)
    return (det, variables, jax_build(cfg, JAX_DATASETS),
            port, build_from_cfg({**cfg, "device": "cpu"}, DATASETS))


ARGS = dict(test_cfg=U.TINY_CFG["test_cfg"], canvas_hw=CANVAS, img_norm=NORM)


def _pair(got, want, tol=1e-4):
    """Per image: equal counts, each port detection paired with a JAX one
    of its label, boxes within ``tol`` px, scores within 1e-4."""
    total = 0
    for (gd, gl), (wd, wl) in zip(got, want):
        assert len(gd) == len(wd)
        free = list(range(len(wd)))
        for d, lab in zip(gd, gl):
            match = [j for j in free if wl[j] == lab
                     and np.abs(wd[j][:4] - d[:4]).max() <= tol
                     and abs(wd[j][4] - d[4]) <= 1e-4]
            assert match, (d, lab)
            free.remove(match[0])
        total += len(gd)
    return total


def test_single_device_test_flip_is_jax(models):
    det, variables, jax_ds, port, port_ds = models
    want = jax_test.single_device_test(det, variables, jax_ds, img_scale=SCALE,
                                       evaluate=False, flip=True,
                                       boxes_only=True, **ARGS)
    got = port_test.single_device_test(port, None, port_ds, img_scale=SCALE,
                                       evaluate=False, flip=True,
                                       boxes_only=True, device="cpu", **ARGS)
    assert _pair(got, want) > 0
    plain = port_test.single_device_test(port, None, port_ds, img_scale=SCALE,
                                         evaluate=False, device="cpu", **ARGS)
    assert any(len(a[0]) != len(b[0]) or not np.array_equal(a[0], b[0])
               for a, b in zip(got, plain))


def test_tta_test_is_jax(models):
    det, variables, jax_ds, port, port_ds = models
    want = jax_test.tta_test(det, variables, jax_ds, img_scales=(SCALE,),
                             evaluate=False, **ARGS)
    got = port_test.tta_test(port, None, port_ds, img_scales=(SCALE,),
                             evaluate=False, device="cpu", **ARGS)
    assert _pair(got, want) > 0


def test_tta_test_dense_is_jax(models, monkeypatch):
    det, variables, jax_ds, port, port_ds = models
    want = jax_test.tta_test_dense(det, variables, jax_ds, img_scales=(SCALE,),
                                   evaluate=False, **ARGS)
    with monkeypatch.context() as m:    # no NMS on the device: host merge
        m.setattr(fcos_head, "multiclass_nms", None)
        got = port_test.tta_test_dense(port, None, port_ds, img_scales=(SCALE,),
                                       evaluate=False, device="cpu", **ARGS)
    assert _pair(got, want) > 0
    other = types.SimpleNamespace(bbox_head=torch.nn.Identity())
    with pytest.raises(NotImplementedError, match="FCOS-family"):
        port_test.tta_test_dense(other, None, port_ds, device="cpu", **ARGS)
