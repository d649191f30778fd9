"""The port's instance masks, their pipelines and the ``segm`` evaluation
against the JAX package and OpenCV 5.0, on the CPU.

- ``rasterize_polygons`` (the even-odd pixel-centre rule, integer,
  half-pixel and free coordinates, several polygons per instance): equal;
- ``encode_rle`` / ``decode_rle`` / ``rle_area`` / ``mask_iou`` (crowd GT
  too): equal, and the round trip gives the mask back;
- ``image_ops.resize_nearest``: bit for bit ``cv2.resize(INTER_NEAREST)``
  at the train scales and at seeded sizes;
- ``BitmapMasks`` and ``PolygonMasks``: every method equal to the JAX
  class's;
- ``LoadAnnotations(with_mask)`` on a COCO instance set (polygons, RLE,
  crowd RLE, no segmentation): the masks equal, ``poly2mask=False``
  keeping polygons where the JAX rule does;
- the mask train pipeline (``Resize`` of several scales, ``RandomFlip``,
  ``Pad``) then ``format_sample``'s ``gt_mask_crops`` and
  ``gt_mask_areas``: equal on seeded draws; ``gt_mask_crop`` alone equal
  to OpenCV's crop up to an 8x upscale and, past it, differing only at
  pixels whose OpenCV value lies within ``CROP_ULPS`` ulps of 0.5 (counted);
- ``Resize`` and ``Pad`` refuse ``PolygonMasks`` in both packages with
  the same ``AttributeError``;
- ``COCOEval(iou_type="segm")`` and ``CocoDataset.evaluate(["bbox",
  "segm"])`` on noisy masks: stats within 1e-12 of the JAX package's; the
  GT fed back scores ``segm_mAP`` 1.0.
"""

import copy
import json
import random

import cv2
import numpy as np
import pytest
import torch

from dsl_tpu.core import masks as J
from dsl_tpu.core.eval.coco_eval import COCOEval as JaxCOCOEval
from dsl_tpu.data import datasets as jax_datasets  # noqa: F401 (registers)
from dsl_tpu.data.coco_api import COCO as JaxCOCO
from dsl_tpu.data.formatting import format_sample as j_format
from dsl_tpu.data.pipelines import Compose as JCompose
from dsl_tpu.models.roi_heads.mask_head import gt_mask_crop as j_crop
from dsl_tpu.registry import DATASETS as JAX_DATASETS
from dsl_tpu.registry import build_from_cfg as jax_build
from dsl_tpu_torch.core import masks as P
from dsl_tpu_torch.core.eval.coco_eval import COCOEval
from dsl_tpu_torch.data.coco_api import COCO
from dsl_tpu_torch.data.formatting import format_sample
from dsl_tpu_torch.data.pipelines import Compose
from dsl_tpu_torch.data.pipelines.image_ops import resize_nearest
from dsl_tpu_torch.models.roi_heads.mask_head import gt_mask_crop
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.utils.synthetic_data import make_coco_instance_dir
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

CROP_ULPS = 32     # the float resize past an 8x upscale (image_ops)
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
MASK_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True, with_mask=True),
    dict(type="Resize", img_scale=[(160, 96), (200, 120), (96, 64)],
         multiscale_mode="value", keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
]


def _polygons(rng, h, w, n_polys, mode):
    out = []
    for _ in range(n_polys):
        n = rng.randint(3, 12)
        pts = np.stack([rng.uniform(-4, w + 4, n), rng.uniform(-4, h + 4, n)], 1)
        if mode == "int":
            pts = np.round(pts)
        elif mode == "half":
            pts = np.round(pts * 2) / 2
        out.append(pts.reshape(-1).tolist())
    return out


@pytest.mark.parametrize("mode", ["free", "int", "half"])
def test_rasterize_polygons_is_jax(mode):
    rng = np.random.RandomState({"free": 0, "int": 1, "half": 2}[mode])
    for _ in range(40):
        h, w = rng.randint(4, 60, 2)
        polys = _polygons(rng, h, w, rng.randint(1, 4), mode)
        polys.append([1.0, 2.0, 3.0, 4.0])            # under 3 points: skipped
        np.testing.assert_array_equal(
            P.rasterize_polygons(polys, h, w).numpy(),
            J.rasterize_polygons(polys, h, w))
    # a square [x1, y1, x2, y2] covers (x2 - x1) * (y2 - y1) pixels
    sq = P.rasterize_polygons([[2, 3, 9, 3, 9, 7, 2, 7]], 12, 12)
    assert int(sq.sum()) == 7 * 4


def test_rle_and_mask_iou_are_jax():
    rng = np.random.RandomState(3)
    masks = (rng.rand(6, 17, 23) < rng.rand(6, 1, 1)).astype(np.uint8)
    masks[0] = 0
    masks[1] = 1
    for m in masks:
        rle = P.encode_rle(m)
        assert rle == J.encode_rle(m)
        np.testing.assert_array_equal(P.decode_rle(rle), m)
        np.testing.assert_array_equal(P.decode_rle(rle), J.decode_rle(rle))
        assert P.rle_area(rle) == J.rle_area(rle) == int(m.sum())
    crowd = np.array([False, True, False])
    np.testing.assert_array_equal(P.mask_iou(masks, masks[:3], crowd),
                                  J.mask_iou(masks, masks[:3], crowd))
    assert P.mask_iou(masks[:0], masks, np.zeros(6, bool)).shape == (0, 6)


@pytest.mark.parametrize("src,dst", [
    ((427, 640), (800, 1199)), ((480, 640), (768, 1024)),
    ((375, 500), (640, 853)), ((640, 427), (1333, 889)), ((7, 5), (3, 2)),
    ((1, 9), (4, 30))])
def test_nearest_resize_is_cv2(src, dst):
    rng = np.random.RandomState(src[0] + dst[1])
    m = rng.randint(0, 2, (3, *src)).astype(np.uint8)
    got = resize_nearest(torch.from_numpy(m), *dst).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], cv2.resize(m[i], dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_nearest_resize_is_cv2_at_seeded_sizes():
    rng = np.random.RandomState(7)
    for _ in range(60):
        h, w, nh, nw = rng.randint(1, 160, 4)
        m = rng.randint(0, 256, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(m), nh, nw).numpy(),
            cv2.resize(m, (int(nw), int(nh)), interpolation=cv2.INTER_NEAREST))


def test_bitmap_and_polygon_masks_are_jax():
    rng = np.random.RandomState(5)
    h, w = 37, 53
    polys = [_polygons(rng, h, w, rng.randint(1, 3), "free") for _ in range(4)]
    jp, pp = J.PolygonMasks(polys, h, w), P.PolygonMasks(polys, h, w)
    np.testing.assert_array_equal(pp.areas, jp.areas)
    for a, b in ((pp.rescale(1.7), jp.rescale(1.7)),
                 (pp.rescale((0.6, 1.3)), jp.rescale((0.6, 1.3))),
                 (pp.flip("horizontal"), jp.flip("horizontal")),
                 (pp.flip("vertical"), jp.flip("vertical"))):
        assert (a.height, a.width) == (b.height, b.width)
        for x, y in zip(a.masks, b.masks):
            for p, q in zip(x, y):
                np.testing.assert_array_equal(p, q)
    jb, pb = jp.to_bitmap(), pp.to_bitmap()
    np.testing.assert_array_equal(pb.masks.numpy(), jb.masks)
    np.testing.assert_array_equal(pb.areas.numpy(), jb.areas)
    for a, b in ((pb.resize((80, 61)), jb.resize((80, 61))),
                 (pb.rescale(2.3), jb.rescale(2.3)),
                 (pb.rescale((0.5, 1.5)), jb.rescale((0.5, 1.5))),
                 (pb.flip("horizontal"), jb.flip("horizontal")),
                 (pb.flip("vertical"), jb.flip("vertical")),
                 (pb.crop((3.7, -2, 40.2, 30)), jb.crop((3.7, -2, 40.2, 30))),
                 (pb.pad((64, 64)), jb.pad((64, 64))), (pb[1:3], jb[1:3])):
        assert (a.height, a.width) == (b.height, b.width)
        np.testing.assert_array_equal(a.masks.numpy(), b.masks)
    empty = P.BitmapMasks([], h, w).resize((9, 11))
    assert tuple(empty.masks.shape) == (0, 9, 11)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in
               FIXTURES.items()]
    return make_coco_instance_dir(tmp_path_factory.mktemp("coco"), sources,
                                  n_train=4, n_val=4, seed=0)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A val set whose annotations are laid on small image sizes (the
    evaluation reads only the json)."""
    sources = [(str(OUT / f"{n}.jpg"), 48 + 8 * i, 64 + 8 * i)
               for i, n in enumerate(FIXTURES)]
    return make_coco_instance_dir(tmp_path_factory.mktemp("small"), sources,
                                  n_train=1, n_val=6, seed=1)


def _datasets(coco, split="train"):
    cfg = dict(type="CocoDataset", ann_file=coco[split],
               img_prefix=coco[f"{split}_images"], pipeline=[],
               test_mode=True)
    jds = jax_build(dict(cfg), JAX_DATASETS)
    pds = build_from_cfg({**cfg, "device": "cpu",
                          "rng": np.random.RandomState(0),
                          "pyrng": random.Random(0)}, DATASETS)
    return jds, pds


def _results(ds, i, device=None):
    r = dict(img_info=dict(ds.data_infos[i]), ann_info=ds.get_ann_info(i),
             img_prefix=ds.img_prefix, bbox_fields=[], mask_fields=[])
    if device:
        r["device"] = device
    return r


@pytest.mark.parametrize("poly2mask", [True, False])
def test_load_annotations_masks_are_jax(coco, poly2mask):
    jds, pds = _datasets(coco)
    kinds = set()
    for i in range(len(jds)):
        step = [dict(type="LoadAnnotations", with_mask=True,
                     poly2mask=poly2mask)]
        want = JCompose(step)(_results(jds, i))["gt_masks"]
        got = Compose(step)(_results(pds, i, "cpu"),
                            np.random.RandomState(0))["gt_masks"]
        assert type(got).__name__ == type(want).__name__
        kinds.add(type(got).__name__)
        if isinstance(want, J.BitmapMasks):
            np.testing.assert_array_equal(got.masks.numpy(), want.masks)
        else:
            for x, y in zip(got.masks, want.masks):
                for p, q in zip(x, y):
                    np.testing.assert_array_equal(p, q)
    assert "BitmapMasks" in kinds
    assert ("PolygonMasks" in kinds) == (not poly2mask)
    # the semantic map loads too (held to JAX's in test_torch_port_htc.py)
    assert Compose([dict(type="LoadAnnotations", with_seg=True)])


@pytest.mark.parametrize("seed", range(4))
def test_mask_pipeline_and_crops_are_jax(coco, seed):
    jds, pds = _datasets(coco)
    i = seed % len(jds)
    np.random.seed(seed)
    ref = JCompose(copy.deepcopy(MASK_PIPELINE))(_results(jds, i))
    gen = np.random.RandomState(seed)
    port = Compose(copy.deepcopy(MASK_PIPELINE))(_results(pds, i, "cpu"), gen)
    np.testing.assert_array_equal(port["gt_masks"].masks.numpy(),
                                  ref["gt_masks"].masks)
    np.testing.assert_array_equal(port["gt_bboxes"], ref["gt_bboxes"])
    assert port["flip"] == ref["flip"] and port["scale"] == ref["scale"]
    want = j_format(ref, canvas_hw=(128, 224), max_gt=8)
    got = format_sample(port, canvas_hw=(128, 224), max_gt=8)
    np.testing.assert_array_equal(got["gt_mask_crops"].numpy(),
                                  want["gt_mask_crops"])
    np.testing.assert_array_equal(got["gt_mask_areas"].numpy(),
                                  want["gt_mask_areas"])
    np.testing.assert_array_equal(got["images"].permute(1, 2, 0).numpy(),
                                  want["images"])
    assert gen.rand() == np.random.rand(), "the generators parted"


def _ulps_from_half(v: np.ndarray) -> np.ndarray:
    """The distance of float32 values from 0.5 in ulps of 0.5's binade."""
    return np.abs(v.astype(np.float64) - 0.5) / np.spacing(np.float32(0.5))


@pytest.mark.parametrize("kind", ["exact", "past_8x"])
def test_gt_mask_crop_is_cv2(kind):
    """Crops of random masks: bit for bit OpenCV's float resize where the
    crop upscales 8x or less; past it, the thresholded crop differs only
    where OpenCV's value is within ``CROP_ULPS`` ulps of 0.5."""
    rng = np.random.RandomState(11 if kind == "exact" else 12)
    flips = 0
    for _ in range(30):
        h, w = rng.randint(20, 90, 2)
        m = (rng.rand(h, w) < 0.5).astype(np.uint8)
        side = rng.uniform(15, 60, 2) if kind == "exact" else rng.uniform(2, 13, 2)
        x1, y1 = rng.uniform(-3, w - 4), rng.uniform(-3, h - 4)
        box = np.asarray([x1, y1, x1 + side[0], y1 + side[1]], np.float32)
        want = j_crop(m, box)
        got = gt_mask_crop(torch.from_numpy(m), box).numpy()
        if kind == "exact":
            np.testing.assert_array_equal(got, want)
            continue
        diff = (got >= 0.5) != (want >= 0.5)
        assert (_ulps_from_half(want[diff]) <= CROP_ULPS).all()
        flips += int(diff.sum())
    print(f"crops past 8x: {flips} thresholded pixels differ, each within "
          f"{CROP_ULPS} ulps of 0.5")


def test_polygon_masks_are_refused_by_resize_and_pad_in_both(coco):
    jds, pds = _datasets(coco)
    load = [dict(type="LoadAnnotations", with_mask=True, poly2mask=False)]
    i = next(i for i in range(len(jds)) if isinstance(
        JCompose(load)(_results(jds, i))["gt_masks"], J.PolygonMasks))
    for method, step in (("resize", dict(type="Resize", img_scale=(96, 64),
                                         keep_ratio=True)),
                         ("pad", dict(type="Pad", size_divisor=32))):
        pipe = [dict(type="LoadImageFromFile")] + load + [step]
        match = f"'PolygonMasks' object has no attribute '{method}'"
        with pytest.raises(AttributeError, match=match):
            JCompose(copy.deepcopy(pipe))(_results(jds, i))
        with pytest.raises(AttributeError, match=match):
            Compose(copy.deepcopy(pipe))(_results(pds, i, "cpu"),
                                         np.random.RandomState(0))


def _noisy_masks(coco, seed: int):
    """Per val image: GT-like detections (dets, labels, masks at the
    original size) with pixels flipped, some dropped, a false positive."""
    rng = np.random.RandomState(seed)
    gt = json.loads(open(coco["val"]).read())
    cats = [c["id"] for c in gt["categories"]]
    out = []
    for img in gt["images"]:
        h, w = img["height"], img["width"]
        dets, labels, masks = [], [], []
        for a in gt["annotations"]:
            if a["image_id"] != img["id"] or a["iscrowd"] or rng.rand() < 0.2:
                continue
            seg = a["segmentation"]
            m = (J.decode_rle(seg) if isinstance(seg, dict)
                 else J.rasterize_polygons(seg, h, w))
            m = m ^ (rng.rand(h, w) < 0.02).astype(np.uint8)
            x, y, bw, bh = a["bbox"]
            dets.append([x, y, x + bw, y + bh, rng.uniform(0.2, 1.0)])
            labels.append(cats.index(a["category_id"]))
            masks.append(m)
        fp = np.zeros((h, w), np.uint8)
        fp[10:30, 20:50] = 1
        dets.append([20, 10, 50, 30, 0.5])
        labels.append(0)
        masks.append(fp)
        out.append((np.asarray(dets, np.float32), np.asarray(labels, np.int64),
                    np.stack(masks)))
    return out


@pytest.mark.parametrize("seed", range(2))
def test_segm_eval_matches_jax(small, seed):
    coco = small
    jds, pds = _datasets(coco, "val")
    results = _noisy_masks(coco, seed)
    dt = pds.results2json_segm(results)
    assert dt == jds.results2json_segm(results)
    got = COCOEval(COCO(coco["val"]), copy.deepcopy(dt), iou_type="segm",
                   img_ids=[d["id"] for d in pds.data_infos],
                   cat_ids=pds.cat_ids).evaluate()
    want = JaxCOCOEval(JaxCOCO(coco["val"]), copy.deepcopy(dt),
                       iou_type="segm",
                       img_ids=[d["id"] for d in jds.data_infos],
                       cat_ids=jds.cat_ids).evaluate()
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert 0 < got["mAP"] < 1
    # the masks as RLEs (what the port's test path gives) evaluate alike
    rles = [(d, lab, [P.encode_rle(m) for m in ms]) for d, lab, ms in results]
    a = pds.evaluate(rles, metric=["bbox", "segm"], verbose=False)
    b = jds.evaluate(results, metric=["bbox", "segm"], verbose=False)
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)


def test_segm_of_the_gt_fed_back_is_one(small):
    _, pds = _datasets(small, "val")
    gt = json.loads(open(small["val"]).read())
    results = []
    for info in pds.data_infos:
        anns = [a for a in gt["annotations"]
                if a["image_id"] == info["id"] and not a["iscrowd"]]
        dets = np.asarray([[a["bbox"][0], a["bbox"][1],
                            a["bbox"][0] + a["bbox"][2],
                            a["bbox"][1] + a["bbox"][3], 1.0] for a in anns],
                          np.float32)
        labels = np.asarray([pds.cat2label[a["category_id"]] for a in anns])
        masks = [a["segmentation"] if isinstance(a["segmentation"], dict)
                 else P.encode_rle(P.rasterize_polygons(
                     a["segmentation"], info["height"], info["width"]).numpy())
                 for a in anns]
        results.append((dets, labels, masks))
    metrics = pds.evaluate(results, metric=["bbox", "segm"], verbose=False)
    assert metrics["segm_mAP"] == 1.0 and metrics["bbox_mAP"] == 1.0
