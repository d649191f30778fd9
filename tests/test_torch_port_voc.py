"""DSL's VOC protocol in the port against the JAX package, on the CPU.

- ``core/eval/mean_ap``: ``eval_map`` on seeded detections and
  annotations (area AP and the VOC2007 11-point AP, ``scale_ranges``,
  ignore boxes with and without ``labels_ignore``, the ImageNet rule)
  within 1e-6 of the JAX function, class by class; ``eval_recalls`` and
  ``average_precision`` exactly;
- ``image_io.image_size``: PIL's stored size and ``cv2.imread``'s shape
  (an EXIF orientation 6 copy swaps only the second), a PNG, a missing
  file, a header cut short, another format;
- ``XMLDataset`` / ``VOCDataset``: ``data_infos`` and ``get_ann_info``
  equal to the JAX classes' (difficult and too small boxes as ignore
  boxes, a name outside the classes, an XML without ``<size>`` whose image
  is EXIF-rotated, filtering), and ``evaluate`` equal, with the 11-point
  AP exactly where the ``img_prefix`` names ``VOC2007``;
- ``Voc2CocoDataset``: the COCO index and the COCO metrics equal;
- ``SemiVOCDataset`` over what ``tools/voc_convert2_semivoc_json.py`` makes
  of a synthetic VOC directory (``make_voc_dir``), with a text list and a
  JSON listing: ``data_infos``, ``get_ann_info`` (score triage) and the
  exported detections' ids equal to the JAX class's;
- the VOC config's datasets build in the port, and ``train_detector`` runs
  it (tiny flagship, 64x96, one epoch): both sets ``SemiVOCDataset``, the
  refresh writes VOC tags, ``Voc2CocoDataset`` evaluates the teacher; the
  ``slow`` run of both packages writes the same label files.
"""

import copy
import json
import runpy
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_util as U
from dsl_tpu.core.eval import mean_ap as jax_mean_ap
from dsl_tpu.data import datasets as jax_datasets  # noqa: F401 (registers)
from dsl_tpu.registry import DATASETS as JAX_DATASETS
from dsl_tpu.registry import build_from_cfg as jax_build
from dsl_tpu_torch.apis import train_detector
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.core.eval import class_names, mean_ap
from dsl_tpu_torch.data import image_io
from dsl_tpu_torch.data.datasets import VOC_CLASSES
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.utils import synthetic_data
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
VOC_CONFIG = REPO / "configs/fcos_semi/voc/RLA_r50_fcos_semi_voc.py"
PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=(96, 64), keep_ratio=True),
]
N_CLASSES = 5


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, size / 2, (n, 2))],
                          1).astype(np.float32)


def _map_inputs(seed: int, ignore: bool, labels_ignore: bool):
    """Per image: annotations with 0-6 boxes of 5 classes (and 0-2 ignore
    boxes), detections per class: jittered copies of most GT boxes, some
    false positives and hits on ignore boxes, seeded scores."""
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(12):
        n = rng.randint(0, 7)
        gt, labels = _boxes(rng, n), rng.randint(0, N_CLASSES, n)
        ann = dict(bboxes=gt, labels=labels)
        if ignore:
            m = rng.randint(0, 3)
            ann["bboxes_ignore"] = _boxes(rng, m)
            if labels_ignore:
                ann["labels_ignore"] = rng.randint(0, N_CLASSES, m)
        anns.append(ann)
        per_class = []
        for c in range(N_CLASSES):
            own = gt[labels == c]
            hit = own[rng.rand(len(own)) < 0.8]
            boxes = [hit + rng.normal(0, 2, hit.shape).astype(np.float32),
                     _boxes(rng, rng.randint(0, 3))]
            if ignore and len(ann["bboxes_ignore"]):
                boxes.append(ann["bboxes_ignore"][:1])
            b = np.concatenate(boxes)
            per_class.append(np.concatenate(
                [b, rng.uniform(0, 1, (len(b), 1)).astype(np.float32)], 1))
        dets.append(per_class)
    return dets, anns


MAP_CASES = {
    "area": dict(),
    "voc07": dict(dataset="voc07"),
    "eleven_points": dict(mode="11points"),
    "iou_0.7": dict(iou_thr=0.7),
    "scale_ranges": dict(scale_ranges=[(0, 32), (32, 64), (64, 1e5)]),
    "imagenet": dict(dataset="det"),
    "imagenet_scales": dict(dataset="det", scale_ranges=[(0, 40), (40, 1e5)]),
}


@pytest.mark.parametrize("ignore", ["none", "with_labels", "no_labels"])
@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_eval_map_matches_jax(case, ignore):
    dets, anns = _map_inputs(sorted(MAP_CASES).index(case), ignore != "none",
                             ignore == "with_labels")
    got_map, got = mean_ap.eval_map(copy.deepcopy(dets), copy.deepcopy(anns),
                                    **MAP_CASES[case])
    want_map, want = jax_mean_ap.eval_map(copy.deepcopy(dets),
                                          copy.deepcopy(anns), **MAP_CASES[case])
    np.testing.assert_allclose(got_map, want_map, rtol=0, atol=1e-6)
    assert 0 < np.mean(got_map) < 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["num_dets"] == w["num_dets"]
        np.testing.assert_array_equal(g["num_gts"], w["num_gts"])
        for key in ("ap", "recall", "precision"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-6)


def test_eval_recalls_and_average_precision_are_jax():
    rng = np.random.RandomState(7)
    gts = [_boxes(rng, rng.randint(0, 6)) for _ in range(10)] + [None]
    props = []
    for g in gts:
        near = (g if g is not None else np.zeros((0, 4), np.float32))
        p = np.concatenate([near + rng.normal(0, 3, near.shape), _boxes(rng, 30)])
        props.append(np.concatenate([p, rng.rand(len(p), 1)], 1).astype(np.float32))
    for nums, thrs in (((5, 10, 40), (0.5,)), (100, (0.3, 0.5, 0.7, 0.9))):
        np.testing.assert_array_equal(
            mean_ap.eval_recalls(gts, props, nums, thrs),
            jax_mean_ap.eval_recalls(gts, props, nums, thrs))
    assert mean_ap.eval_recalls([None], [props[0]]).sum() == 0
    rec = np.sort(rng.rand(3, 40), axis=1)
    prec = rng.rand(3, 40)
    for mode in ("area", "11points"):
        np.testing.assert_array_equal(
            mean_ap.average_precision(rec, prec, mode),
            jax_mean_ap.average_precision(rec, prec, mode))
        assert mean_ap.average_precision(rec[0], prec[0], mode) == \
            jax_mean_ap.average_precision(rec[0], prec[0], mode)
    with pytest.raises(ValueError):
        mean_ap.average_precision(rec, prec, "unknown")


def test_class_names_are_jax():
    from dsl_tpu.core.eval import class_names as jax_names

    for name in ("coco", "voc", "pascal_voc", "cityscapes", "wider_face",
                 "widerface", "deepfashion", "VOC"):
        assert class_names.get_classes(name) == jax_names.get_classes(name)
    assert tuple(class_names.voc_classes()) == VOC_CLASSES
    with pytest.raises(ValueError, match="Unrecognized"):
        class_names.get_classes("kitti")


def test_image_size_is_pil_and_cv2(tmp_path):
    """The stored size (PIL) and the decoded one (OpenCV, EXIF applied)."""
    rotated = tmp_path / "rotated.jpg"
    rotated.write_bytes(U.with_exif((OUT / "coco_640x427.jpg").read_bytes(),
                                    U.exif_segment(6)))
    png = tmp_path / "a.png"
    cv2.imwrite(str(png), np.zeros((33, 41, 3), np.uint8))
    for path in (OUT / "coco_500x375.jpg", OUT / "gray_640x480.jpg", rotated, png):
        with Image.open(path) as im:
            assert image_io.image_size(path, oriented=False) == im.size
        h, w = cv2.imread(str(path)).shape[:2]
        assert image_io.image_size(path, oriented=True) == (w, h)
    assert image_io.image_size(rotated, oriented=True) == (427, 640)
    assert image_io.image_size(tmp_path / "missing.jpg", oriented=True) == (0, 0)
    assert image_io.image_size(tmp_path / "missing.jpg", oriented=False) == (0, 0)
    cut = tmp_path / "cut.jpg"
    cut.write_bytes((OUT / "coco_500x375.jpg").read_bytes()[:300])
    assert cv2.imread(str(cut)) is None
    assert image_io.image_size(cut, oriented=True) == (0, 0)
    with pytest.raises(ValueError, match="cut short"):
        image_io.image_size(cut, oriented=False)
    bmp = tmp_path / "a.bmp"
    cv2.imwrite(str(bmp), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="BMP"):
        image_io.image_size(bmp, oriented=True)


def _xml(objects, size=(120, 100)):
    objs = "".join(
        f"<object><name>{n}</name><difficult>{d}</difficult>"
        f"<bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
        f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
        for n, d, b in objects)
    size = ("" if size is None else f"<size><width>{size[0]}</width><height>"
            f"{size[1]}</height><depth>3</depth></size>")
    return f"<annotation>{size}{objs}</annotation>"


@pytest.fixture
def voc_dir(tmp_path):
    """Four images: a plain one, one with a difficult and a tiny box and a
    name outside the classes, one whose XML has no ``<size>`` and whose
    JPEG carries EXIF orientation 6 (OpenCV's shape is the stored one
    turned), and one with only a difficult box."""
    root = tmp_path / "VOC2007"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    data = (OUT / "coco_500x375.jpg").read_bytes()
    for i in range(4):
        body = U.with_exif(data, U.exif_segment(6)) if i == 2 else data
        (root / "JPEGImages" / f"00000{i}.jpg").write_bytes(body)
    xmls = [
        _xml([("dog", 0, (10, 10, 50, 50)), ("person", 0, (60, 5, 110, 95))]),
        _xml([("cat", 1, (60, 60, 90, 90)), ("dog", 0, (5, 5, 9, 9)),
              ("unicorn", 0, (1, 1, 20, 20)), ("car", 0, (20, 30, 80, 70))]),
        _xml([("person", 0, (5, 5, 40, 70))], size=None),
        _xml([("bird", 1, (10, 10, 30, 30))]),
    ]
    for i, x in enumerate(xmls):
        (root / "Annotations" / f"00000{i}.xml").write_text(x)
    (root / "list.txt").write_text("000000\n000001\n000002\n000003\n")
    return root


def _both(cfg: dict):
    port = build_from_cfg({**cfg, "device": "cpu"}, DATASETS)
    return port, jax_build(copy.deepcopy(cfg), JAX_DATASETS)


def _ann_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kind,min_size,test_mode", [
    ("VOCDataset", None, False), ("VOCDataset", 8, False),
    ("XMLDataset", 8, True), ("VOCDataset", None, True)])
def test_xml_datasets_are_jax(voc_dir, kind, min_size, test_mode):
    port, jax = _both(dict(type=kind, ann_file=str(voc_dir / "list.txt"),
                           img_prefix=str(voc_dir), pipeline=PIPELINE,
                           min_size=min_size, test_mode=test_mode))
    assert port.data_infos == jax.data_infos
    assert len(port) == (4 if test_mode else 3)
    assert port.data_infos[2] == dict(
        id="000002", filename="JPEGImages/000002.jpg", width=375, height=500)
    for i in range(len(port)):
        _ann_equal(port.get_ann_info(i), jax.get_ann_info(i))
    ann = port.get_ann_info(1)
    assert ann["labels_ignore"].tolist() == [VOC_CLASSES.index("cat")] + (
        [VOC_CLASSES.index("dog")] if min_size else [])


def _voc_results(ds, seed: int):
    """Per image: jittered GT, the ignore boxes, false positives."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        b = np.concatenate([ann["bboxes"] + rng.normal(0, 3, ann["bboxes"].shape),
                            ann["bboxes_ignore"], _boxes(rng, 3)]).astype(np.float32)
        labels = np.concatenate([ann["labels"], ann["labels_ignore"],
                                 rng.randint(0, 20, 3)])
        out.append((np.concatenate([b, rng.rand(len(b), 1).astype(np.float32)],
                                   1), labels))
    return out


def test_voc_evaluate_is_jax_and_eleven_points_by_prefix(voc_dir, tmp_path):
    """The same metrics as the JAX class's, from the same results; the
    11-point AP where the prefix names VOC2007, area AP elsewhere."""
    other = tmp_path / "VOC2012"
    other.symlink_to(voc_dir)
    for prefix, mode in ((voc_dir, "11points"), (other, "area")):
        port, jax = _both(dict(type="VOCDataset", test_mode=True,
                               ann_file=str(voc_dir / "list.txt"),
                               img_prefix=str(prefix), pipeline=PIPELINE))
        results = _voc_results(port, 3)
        got = port.evaluate(results, metric="bbox")
        assert got == jax.evaluate(results, metric="mAP")
        per_class = [[d[lab == c] for c in range(20)] for d, lab in results]
        assert got["mAP"] == mean_ap.eval_map(
            per_class, [port.get_ann_info(i) for i in range(len(port))],
            mode=mode)[0]
        assert got["AP50"] == got["mAP"] and 0 < got["mAP"] < 1
    assert port.evaluate(results, iou_thr=0.7)["AP50"] is None


def test_voc2coco_is_jax(voc_dir):
    cfg = dict(type="Voc2CocoDataset", ann_file=str(voc_dir / "list.txt"),
               img_prefix=str(voc_dir), pipeline=PIPELINE, test_mode=True)
    port, jax = _both(cfg)
    assert port.coco.dataset == jax.coco.dataset
    assert port.data_infos == jax.data_infos
    assert (port.cat_ids, port.img_ids) == (jax.cat_ids, jax.img_ids)
    assert [a["ignore"] for a in port.coco.dataset["annotations"]] == [
        0, 0, 1, 0, 0, 0, 1]
    voc = build_from_cfg({**cfg, "type": "VOCDataset", "device": "cpu"}, DATASETS)
    results = _voc_results(voc, 5)
    got = port.evaluate(results, verbose=False)
    assert got == jax.evaluate(results, verbose=False)
    assert 0 < got["bbox_mAP"] < 1


@pytest.fixture
def semivoc(tmp_path):
    """A synthetic VOC directory made into DSL's layout by the converter
    itself, with an unlabeled split (seeded labels, then scores on half)."""
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    voc = synthetic_data.make_voc_dir(tmp_path / "voc", sources, 4, 4, seed=1)
    argv = sys.argv
    sys.argv = ["voc_convert2_semivoc_json.py", "--voc-root", voc["voc_root"],
                "--split", voc["trainval"], "--output", str(tmp_path / "voc")]
    try:
        runpy.run_path(str(REPO / "tools/voc_convert2_semivoc_json.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    paths = synthetic_data.make_semivoc_unlabeled(tmp_path / "voc", sources, 6)
    rng = np.random.RandomState(2)
    store = Path(paths["unlabel_store"])
    for name in sorted(store.iterdir())[::2]:
        label = json.loads(name.read_text())
        label["scores"] = rng.uniform(0, 1, label["targetNum"]).round(3).tolist()
        name.write_text(json.dumps(label))
    return paths


@pytest.mark.parametrize("split,thres", [
    ("labeled", None), ("unlabeled", [0.2, 0.5]), ("unlabeled", "adathres"),
    ("unlabeled", None)])
def test_semivoc_dataset_is_jax(semivoc, split, thres, tmp_path):
    if thres == "adathres":
        thres = semivoc["adathres"]
        Path(thres).write_text(json.dumps(dict(thres={"dog": 0.6, "cat": 0.2})))
    images = semivoc["images" if split == "labeled" else "unlabel_images"]
    cfg = dict(type="SemiVOCDataset", ann_file=semivoc[split],
               ann_path=semivoc["label_store" if split == "labeled"
                                else "unlabel_store"],
               labelmapper=semivoc["category_info"], img_prefix=images,
               pipeline=PIPELINE, thres=thres)
    port, jax = _both(cfg)
    assert port.data_infos == jax.data_infos and len(port) >= 3
    assert port.coco.dataset == jax.coco.dataset
    assert port.img_ids == jax.img_ids
    for i in range(len(port)):
        _ann_equal(port.get_ann_info(i), jax.get_ann_info(i))
    # detections exported with the list's ids, as the pseudo-label script
    # maps them back
    results = [(np.asarray([[1, 2, 30, 40, 0.9]], np.float32), np.asarray([3]))
               ] * len(port)
    assert port.results2json_bbox(results) == jax.results2json_bbox(results)
    listing = tmp_path / "listing.json"
    listing.write_text(json.dumps(dict(images=[
        dict(file_name=d["filename"]) for d in port.data_infos])))
    port2, jax2 = _both({**cfg, "ann_file": str(listing), "test_mode": True})
    assert port2.data_infos == jax2.data_infos


def test_semivoc_sizes_are_pils(tmp_path):
    """An EXIF-rotated image keeps its stored size; a missing one is 0 x 0
    (and filtered out of a training set)."""
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    data = (OUT / "coco_640x427.jpg").read_bytes()
    (img_dir / "a.jpg").write_bytes(U.with_exif(data, U.exif_segment(6)))
    (tmp_path / "list.txt").write_text("a.jpg\nmissing.jpg\n")
    info = tmp_path / "cats.json"
    cat2id = {c: i for i, c in enumerate(VOC_CLASSES)}
    info.write_text(json.dumps(dict(cat2id=cat2id, id2cat={})))
    port, jax = _both(dict(type="SemiVOCDataset",
                           ann_file=str(tmp_path / "list.txt"),
                           ann_path=str(tmp_path), labelmapper=str(info),
                           img_prefix=str(img_dir), pipeline=PIPELINE,
                           test_mode=True))
    assert port.data_infos == jax.data_infos == [
        dict(filename="a.jpg", width=640, height=427, id=0),
        dict(filename="missing.jpg", width=0, height=0, id=1)]


def test_the_voc_configs_datasets_build_in_the_port(semivoc):
    cfg = synthetic_data.voc_semi_config(
        Config.fromfile(str(VOC_CONFIG))._cfg_dict, semivoc)
    kinds = {}
    for key in ("train", "unlabel_train", "val", "test"):
        ds = build_from_cfg({**cfg["data"][key], "device": "cpu",
                             "test_mode": key in ("val", "test")}, DATASETS)
        kinds[key] = type(ds).__name__
        assert len(ds) > 0
    assert kinds == dict(train="SemiVOCDataset", unlabel_train="SemiVOCDataset",
                         val="Voc2CocoDataset", test="Voc2CocoDataset")
    assert "pipeline" not in Config.fromfile(str(VOC_CONFIG)).data["val"]


def _tiny_voc_cfg(paths, max_epochs: int = 1) -> dict:
    cfg = synthetic_data.voc_semi_config(
        Config.fromfile(str(VOC_CONFIG))._cfg_dict, paths)
    cfg["model"] = copy.deepcopy(U.TINY_CFG)
    cfg["model"]["bbox_head"]["num_classes"] = 20
    cfg["canvas_hw"] = (64, 96)
    cfg["runner"]["max_epochs"] = max_epochs
    cfg["data"]["unlabel_pred"]["start_point"] = 1
    for key in ("train", "unlabel_train"):
        cfg["data"][key]["pipeline"] = PIPELINE + [
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize", **cfg["img_norm_cfg"]),
            dict(type="Pad", size_divisor=32)]
    for key in ("val", "unlabel_pred"):
        cfg["data"][key]["pipeline"][1]["img_scale"] = (96, 64)
    cfg["log_config"] = dict(interval=1)
    return cfg


@pytest.fixture(scope="module")
def tiny_voc():
    cfg = copy.deepcopy(U.TINY_CFG)
    cfg["bbox_head"]["num_classes"] = 20
    return U.jax_detector_and_variables(cfg, seed=0)


def test_train_detector_runs_the_voc_config(semivoc, tiny_voc, tmp_path):
    """One epoch of the VOC config (tiny flagship at 64x96): the refresh
    rewrites every unlabeled label file with VOC tags and scores, and
    ``Voc2CocoDataset`` evaluates the teacher after the epoch."""
    before = U.tree_of(semivoc["unlabel_store"])
    runner = train_detector(Config(_tiny_voc_cfg(semivoc)), str(tmp_path / "w"),
                            device="cpu", variables=tiny_voc[1])
    after = U.tree_of(semivoc["unlabel_store"])
    assert set(after) == set(before)
    for name, data in after.items():
        label = json.loads(data)
        assert data != before[name] and "scores" in label, name
        assert set(label["tags"]) <= set(VOC_CLASSES)
    lines = [json.loads(x) for x in
             (tmp_path / "w" / "train.log.json").read_text().splitlines()]
    val = [x for x in lines if x["mode"] == "val"]
    assert [v["epoch"] for v in val] == [1]
    assert 0 <= val[0]["bbox_mAP"] <= 1
    assert all(np.isfinite(float(v)) for v in runner.log_buffer.history["loss"])


@pytest.mark.slow
def test_voc_run_writes_the_label_files_of_jax(tmp_path, tiny_voc):
    """One epoch of each package's ``train_detector`` on the VOC config from
    the same weights, learning rate 0 (the teacher stays the shared
    weights), the 640x480 fixtures at their own scale (both resizes copy
    the pixels): the same label files (tags and counts, boxes within 1 px,
    scores within 1e-3). It compiles the JAX train step and predict."""
    from dsl_tpu.apis.train import train_detector as jax_train_detector
    from dsl_tpu.config import Config as JaxConfig

    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()
               if (h, w) == (480, 640)]
    runs = {}
    for tag in ("jax", "port"):
        voc = synthetic_data.make_voc_dir(tmp_path / tag, sources, 4, 2)
        argv, sys.argv = sys.argv, [
            "x", "--voc-root", voc["voc_root"], "--split", voc["trainval"],
            "--output", str(tmp_path / tag)]
        try:
            runpy.run_path(str(REPO / "tools/voc_convert2_semivoc_json.py"),
                           run_name="__main__")
        finally:
            sys.argv = argv
        paths = synthetic_data.make_semivoc_unlabeled(tmp_path / tag, sources, 4)
        cfg = _tiny_voc_cfg(paths)
        cfg.pop("evaluation")
        cfg["canvas_hw"] = (480, 640)
        cfg["optimizer"]["lr"] = 0.0
        for key in ("train", "unlabel_train"):
            cfg["data"][key]["pipeline"][2] = dict(
                type="Resize", img_scale=(640, 480), keep_ratio=True)
        cfg["data"]["unlabel_pred"]["pipeline"][1]["img_scale"] = (640, 480)
        if tag == "jax":
            weights = tmp_path / "weights.pth"
            model = copy.deepcopy(cfg["model"])
            torch.save(U.port_detector(model, tiny_voc[1]).state_dict(), weights)
            jax_train_detector(JaxConfig(dict(cfg, load_from=str(weights))),
                               str(tmp_path / "jax_work"), seed=0, max_devices=1)
        else:
            train_detector(Config(cfg), str(tmp_path / "port_work"),
                           device="cpu", variables=tiny_voc[1])
        runs[tag] = paths
    total = 0
    for name in sorted(U.tree_of(runs["jax"]["unlabel_store"])):
        got, want = (json.loads(open(f"{runs[t]['unlabel_store']}/{name}").read())
                     for t in ("port", "jax"))
        assert "scores" in got and "scores" in want
        assert U.pair_labels(got, want)[0] == 0
        total += got["targetNum"]
    assert total > 0
