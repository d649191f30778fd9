"""The port's COCO evaluation against the JAX package's, on the CPU.

- ``COCOEval`` on identical detection lists (noisy copies of the GT, false
  positives, a crowd box): every statistic equal to the JAX package's;
  ``segm`` (ported with the mask path, ``tests/test_torch_port_masks.py``)
  refuses a detection without a ``segmentation``, as the JAX package does;
- the GT of a val set fed back as detections scores ``bbox_mAP`` 1.0;
- ``single_device_test`` on the tiny flagship (``U.TINY_CFG``), 10 val
  images of 64x96 stored losslessly, so both packages' resizes copy the
  pixels, in batches of 8 and 2 on the (64, 96) canvas: per image the same
  detections (paired by label, boxes within 1e-2 px, scores within 1e-4,
  as the predict tests hold them), and each package's detections scored by
  the other's ``evaluate`` give equal metrics;
- ``SemiRunner`` calls ``eval_fn`` after every ``eval_interval``-th epoch
  and writes its metrics to ``train.log`` and ``train.log.json``;
- ``train_detector`` on the tiny flagship with the flagship's own train
  pipelines (``PatchShuffle``, ``RandomAugmentBBox_Fast``, ``UBAug``; only
  the ``Resize`` scales cut to the tiny canvas) and its ``evaluation``
  runs two epochs and evaluates the teacher after each.
"""

import copy
import json
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.apis.test import single_device_test as jax_single_device_test
from dsl_tpu.core.eval.coco_eval import COCOEval as JaxCOCOEval
from dsl_tpu.data import datasets as jax_datasets  # noqa: F401 (registers)
from dsl_tpu.data.coco_api import COCO as JaxCOCO
from dsl_tpu.registry import DATASETS as JAX_DATASETS
from dsl_tpu.registry import build_from_cfg as jax_build
from dsl_tpu_torch.apis import single_device_test, train_detector
from dsl_tpu_torch.apis import test as test_api
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.core.eval.coco_eval import COCOEval
from dsl_tpu_torch.data.coco_api import COCO
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.train.runner import SemiRunner
from dsl_tpu_torch.utils import synthetic_data
from torch_port_make_fixtures import FIXTURES, OUT, load_decodes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="MultiScaleFlipAug", img_scale=(96, 64), flip=False,
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip"), dict(type="Normalize", **NORM),
                     dict(type="Pad", size_divisor=32)]),
]


def _gt_file(path: Path, n_images: int, hw, seed: int, crowd: bool = False):
    """A COCO file of ``n_images`` images of ``hw`` with 1-6 seeded boxes of
    the first 5 of the 80 COCO categories each (one crowd box on the first
    image where asked)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    images, anns = [], []
    for i in range(n_images):
        images.append(dict(id=i + 1, file_name=f"val_{i:03d}.png", height=h,
                           width=w))
        for _ in range(rng.randint(1, 7)):
            bw, bh = rng.uniform(3, w / 2), rng.uniform(3, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.randint(1, 6)),
                             bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
    if crowd:
        anns.append(dict(id=len(anns) + 1, image_id=1, category_id=1,
                         bbox=[0.0, 0.0, w / 2, h / 2], area=w * h / 4,
                         iscrowd=1))
    cats = [dict(id=i + 1, name=c)
            for i, c in enumerate(synthetic_data.COCO_CLASSES)]
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=cats)))
    return path


def _detections(gt_path: Path, seed: int) -> list[dict]:
    """Noisy copies of most GT boxes and some false positives, with scores."""
    rng = np.random.RandomState(seed)
    gt = json.loads(gt_path.read_text())
    dets = []
    for a in gt["annotations"]:
        if rng.rand() < 0.8:
            x, y, w, h = a["bbox"]
            j = rng.normal(0, 0.08, 4) * [w, h, w, h]
            dets.append(dict(image_id=a["image_id"],
                             category_id=a["category_id"],
                             bbox=[x + j[0], y + j[1], w + j[2], h + j[3]],
                             score=float(rng.uniform(0.3, 1))))
    for img in gt["images"]:
        for _ in range(rng.randint(0, 4)):
            dets.append(dict(image_id=img["id"],
                             category_id=int(rng.randint(1, 6)),
                             bbox=list(rng.uniform(0, 30, 4) + [0, 0, 2, 2]),
                             score=float(rng.uniform(0, 0.9))))
    return dets


@pytest.mark.parametrize("seed", range(3))
def test_coco_eval_matches_jax(tmp_path, seed):
    gt = _gt_file(tmp_path / "gt.json", 12, (480, 640), seed, crowd=True)
    dets = _detections(gt, seed)
    got = COCOEval(COCO(str(gt)), copy.deepcopy(dets)).evaluate()
    want = JaxCOCOEval(JaxCOCO(str(gt)), copy.deepcopy(dets)).evaluate()
    assert got == want
    assert 0 < got["mAP"] < 1


def test_coco_eval_refuses_segm(tmp_path):
    """segm evaluation of a box-only detection raises in both packages,
    naming the missing ``segmentation``."""
    gt = _gt_file(tmp_path / "gt.json", 1, (64, 96), 0)
    dets = [dict(image_id=1, category_id=1, bbox=[1.0, 2.0, 10.0, 12.0],
                 score=0.9)]
    for ev in (COCOEval(COCO(str(gt)), copy.deepcopy(dets), iou_type="segm"),
               JaxCOCOEval(JaxCOCO(str(gt)), copy.deepcopy(dets),
                           iou_type="segm")):
        with pytest.raises(KeyError, match="segmentation"):
            ev.evaluate()


def _val_dataset(ann_file, img_prefix, port: bool):
    cfg = dict(type="CocoDataset", ann_file=str(ann_file),
               img_prefix=str(img_prefix), pipeline=TEST_PIPELINE,
               test_mode=True)
    if port:
        return build_from_cfg({**cfg, "device": "cpu"}, DATASETS)
    return jax_build(cfg, JAX_DATASETS)


def test_ground_truth_as_detections_scores_map_one(tmp_path):
    gt = _gt_file(tmp_path / "gt.json", 6, (64, 96), 1)
    ds = _val_dataset(gt, tmp_path, port=True)
    results = []
    for info in ds.data_infos:
        ann = ds.get_ann_info(ds.data_infos.index(info))
        dets = np.concatenate([ann["bboxes"], np.ones((len(ann["bboxes"]), 1),
                                                      np.float32)], 1)
        results.append((dets, ann["labels"]))
    metrics = ds.evaluate(results, verbose=False)
    assert metrics["bbox_mAP"] == 1.0 and metrics["bbox_mAP_50"] == 1.0


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """10 crops of the fixture decodes, 64x96, as PNG, and their COCO file."""
    root = tmp_path_factory.mktemp("val")
    decodes = load_decodes()
    names = sorted(FIXTURES)
    for i in range(10):
        img = decodes[names[i % len(names)]]
        y, x = 37 * i % (img.shape[0] - 64), 53 * i % (img.shape[1] - 96)
        cv2.imwrite(str(root / f"val_{i:03d}.png"), img[y:y + 64, x:x + 96])
    return _gt_file(root / "val.json", 10, (64, 96), 2), root


def _pair_detections(got, want):
    """Per image: equal counts, and each port detection paired with a JAX
    one of its label, boxes within 1e-2 px, scores within 1e-4."""
    total = 0
    for (gd, gl), (wd, wl) in zip(got, want):
        assert len(gd) == len(wd)
        free = list(range(len(wd)))
        for d, lab in zip(gd, gl):
            match = [j for j in free if wl[j] == lab
                     and np.abs(wd[j][:4] - d[:4]).max() <= 1e-2
                     and abs(wd[j][4] - d[4]) <= 1e-4]
            assert match, (d, lab)
            free.remove(match[0])
        total += len(gd)
    return total


def test_single_device_test_matches_jax(val_set):
    ann_file, root = val_set
    det, variables = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    port = U.port_detector(U.TINY_CFG, variables)
    args = dict(test_cfg=U.TINY_CFG["test_cfg"], canvas_hw=(64, 96),
                img_scale=(96, 64), img_norm=NORM)
    jax_ds = _val_dataset(ann_file, root, port=False)
    port_ds = _val_dataset(ann_file, root, port=True)
    want_m, want = jax_single_device_test(det, variables, jax_ds,
                                          return_results=True, **args)
    got_m, got = single_device_test(port, None, port_ds, return_results=True,
                                    device="cpu", **args)
    assert len(got) == len(want) == 10
    assert _pair_detections(got, want) > 0
    assert got_m == port_ds.evaluate(got, verbose=False) == jax_ds.evaluate(
        got, verbose=False)
    assert want_m == port_ds.evaluate(want, verbose=False)
    assert set(got_m) == {f"bbox_mAP{s}" for s in ("", "_50", "_75", "_s",
                                                    "_m", "_l")}


class _Loader:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter({"x": i} for i in range(self.n))


def test_semi_runner_evaluates_at_its_interval(tmp_path):
    calls = []

    def eval_fn(state):
        calls.append(state.step)
        return {"bbox_mAP": 0.25 * len(calls)}

    def train_step(state, batch):
        state.step += 1
        return {"loss": torch.tensor(1.0)}

    runner = SemiRunner(train_step, types.SimpleNamespace(step=0), _Loader(3),
                        str(tmp_path), max_epochs=5, log_interval=100,
                        eval_fn=eval_fn, eval_interval=2,
                        checkpoint_interval=100)
    runner.run()
    assert calls == [6, 12]
    lines = [json.loads(x) for x in
             (tmp_path / "train.log.json").read_text().splitlines()]
    assert lines == [dict(mode="val", epoch=2, bbox_mAP=0.25),
                     dict(mode="val", epoch=4, bbox_mAP=0.5)]
    log = (tmp_path / "train.log").read_text()
    assert "eval epoch 2: {'bbox_mAP': 0.25}" in log
    assert "eval epoch 4: {'bbox_mAP': 0.5}" in log


def test_train_detector_runs_the_flagship_pipelines_and_evaluation(
        tmp_path, monkeypatch):
    _, variables = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    paths = synthetic_data.make_semicoco_dir(tmp_path / "data", sources, 2, 4,
                                             n_val=3)
    cfg = Config.fromfile(str(REPO / "configs/fcos_semi/RLA_r50_fcos_semi_dsl.py"))
    cfg = synthetic_data.semi_config(copy.deepcopy(cfg._cfg_dict), paths)
    assert cfg["evaluation"] == dict(interval=1, metric="bbox")
    cfg["model"] = copy.deepcopy(U.TINY_CFG)
    cfg["canvas_hw"] = (64, 96)
    cfg["runner"]["max_epochs"] = 2
    cfg["data"]["unlabel_pred"]["start_point"] = 1
    for key in ("train", "unlabel_train"):
        resize = next(t for t in cfg["data"][key]["pipeline"]
                      if t["type"] == "Resize")
        resize["img_scale"] = [(96, 64), (96, 48)]
    for key in ("val", "unlabel_pred"):
        cfg["data"][key]["pipeline"][1]["img_scale"] = (96, 64)
    calls = []
    real = test_api.detector_predict

    def counting(*args, **kwargs):
        calls.append(kwargs["params"])
        return real(*args, **kwargs)

    monkeypatch.setattr(test_api, "detector_predict", counting)
    runner = train_detector(Config(cfg), str(tmp_path / "work"),
                            device="cpu", variables=variables)
    vals = [json.loads(x) for x in
            (tmp_path / "work" / "train.log.json").read_text().splitlines()
            if '"val"' in x]
    assert [v["epoch"] for v in vals] == [1, 2]
    assert all(0 <= v["bbox_mAP"] <= 1 for v in vals)
    # one batch of 3 val images per evaluation, on the teacher's parameters
    assert len(calls) == 2 and all(
        p is not None and p.keys() == runner.state.teacher_params.keys()
        for p in calls)
    assert calls[-1] is runner.state.teacher_params
    losses = runner.log_buffer.history["loss"]
    assert len(losses) == 4 and all(np.isfinite(v) for v in losses)
