"""DSL's first step on the port: the supervised baseline and its CLIs.

``configs/fcos_semi/r50_caffe_mslonger_tricks_0.Xdata.py`` (a caffe
ResNet-50 FCOS, no unlabeled set) cut to the tiny widths of
``torch_port_util.TINY_BASELINE_CFG`` and a 64x96 canvas, on a synthetic
semicoco directory of copies of the JPEG fixtures:

- ``train_detector`` without ``data.unlabel_train``: the labeled loader
  alone, no refresher, the EMA teacher kept and checkpointed (as the JAX
  package keeps it), the evaluation after each epoch on the student;
- three epochs through the JAX package's ``semi = False`` branch from
  the same weights (``load_from``), with a 256-wide head: per-iteration
  losses within 1e-4 and ``grad_norm`` within 1e-3 relative (f32 sums in
  another order over a few steps, as the train-step trajectory test
  allows), the student after the last step banded to JAX's, its
  ``bbox_mAP`` within 1e-3 (slow: it compiles the JAX train step);
- ``Config.merge_from_dict``, ``dump`` and ``DictAction`` as the JAX
  package's;
- ``python -m dsl_tpu_torch.tools.train`` and ``tools.test`` in process
  with ``--device cpu``: train, then ``--format-only`` on the unlabeled
  split, ``tools/generate_unlabel_annos_coco.py`` on that json, and the
  port's ``SemiCOCODataset`` reading the label files it wrote; ``--eval``
  on the val set, student and ``--ema``; ``--launcher pytorch`` outside
  ``torch.distributed.run`` (no ``RANK``) and ``--max-devices 2`` without a
  launcher raise, naming what starts the processes.
"""

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.config import Config as JaxConfig
from dsl_tpu.config.config import DictAction as JaxDictAction
from dsl_tpu_torch.apis import train as port_train
from dsl_tpu_torch.apis.train import build_dataset, train_detector
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.config.config import DictAction
from dsl_tpu_torch.tools import test as test_cli
from dsl_tpu_torch.tools import train as train_cli
from dsl_tpu_torch.utils import synthetic_data
from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BASELINE = REPO / "configs" / "fcos_semi" / "r50_caffe_mslonger_tricks_0.Xdata.py"
NORM = dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0],
            to_rgb=False)
TRAIN_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=[(96, 48), (96, 64)],
         multiscale_mode="value", keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
]
TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="MultiScaleFlipAug", img_scale=(96, 64), flip=False,
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip"), dict(type="Normalize", **NORM),
                     dict(type="Pad", size_divisor=32)]),
]
# the baseline config file cut to the tiny widths and scales
TINY_FILE = f"""_base_ = {str(BASELINE)!r}
model = dict(
    backbone=dict(stem_channels=16, base_channels=16),
    neck=dict(in_channels=[64, 128, 256, 512], out_channels=64),
    bbox_head=dict(in_channels=64, feat_channels=64, stacked_convs=1))
canvas_hw = (64, 96)
log_config = dict(interval=1)
data = dict(train=dict(pipeline={TRAIN_PIPELINE!r}),
            val=dict(pipeline={TEST_PIPELINE!r}),
            test=dict(pipeline={TEST_PIPELINE!r}))
"""


def _paths_options(paths: dict) -> dict:
    """``--cfg-options`` that point the config at a synthetic directory."""
    return {"data.train.ann_file": paths["labeled"],
            "data.train.ann_path": paths["label_store"],
            "data.train.labelmapper": paths["category_info"],
            "data.train.img_prefix": paths["images"],
            "data.val.ann_file": paths["val"],
            "data.val.img_prefix": paths["val_images"],
            "data.test.ann_file": paths["val"],
            "data.test.img_prefix": paths["val_images"]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline")
    sources = [(str(OUT / f"{n}.jpg"), h, w)
               for n, (h, w, _) in FIXTURES.items()]
    paths = synthetic_data.make_semicoco_dir(root / "data", sources, 4, 4,
                                             n_val=2)
    cfg_file = root / "tiny_baseline.py"
    cfg_file.write_text(TINY_FILE)
    # seeded weights with live classes (the modules' init scores every
    # class below score_thr), for the runs that must detect something
    _, variables = U.jax_detector_and_variables(U.TINY_BASELINE_CFG, seed=0)
    weights = root / "weights.pth"
    torch.save(U.port_detector(U.TINY_BASELINE_CFG, variables).state_dict(),
               weights)
    return root, paths, str(cfg_file), str(weights)


def _config(cfg_file, paths, **extra):
    cfg = Config.fromfile(cfg_file)
    cfg.merge_from_dict({**_paths_options(paths), "runner.max_epochs": 2,
                         "evaluation.interval": 1, **extra})
    return cfg


def _log_lines(work_dir) -> list[dict]:
    return [json.loads(line) for line in
            open(Path(work_dir) / "train.log.json", encoding="utf-8")]


def test_config_helpers_match_jax(setup, tmp_path):
    root, paths, cfg_file, _ = setup
    options = {**_paths_options(paths), "runner.max_epochs": 2,
               "model.bbox_head.num_classes": 3, "optimizer.lr": 0.02}
    port, ref = Config.fromfile(cfg_file), JaxConfig.fromfile(cfg_file)
    port.merge_from_dict(options)
    ref.merge_from_dict(options)
    assert port.to_dict() == ref.to_dict()
    assert port.dump() == ref.dump()
    port.dump(str(tmp_path / "dumped.py"))
    assert Config.fromfile(str(tmp_path / "dumped.py")).to_dict() == ref.to_dict()
    args = ["a.b=1", "c=[1, 2]", "d=True", "e=none", "f=(96, 64)", "g=word"]
    got, want = argparse.Namespace(), argparse.Namespace()
    DictAction(["--o"], "o")(None, got, args)
    JaxDictAction(["--o"], "o")(None, want, args)
    assert got.o == want.o


def test_supervised_train_detector_runs_two_epochs(setup, tmp_path,
                                                   monkeypatch):
    """No unlabeled set: the labeled loader alone, no refresher; the EMA
    teacher is kept and checkpointed; evaluation runs on the student. cuDNN
    is deterministic while the runner runs, and the process's flags come
    back after it."""
    evaluated = []
    real = port_train.single_device_test

    def record(detector, params, *args, **kwargs):
        cudnn = torch.backends.cudnn
        evaluated.append((params, cudnn.deterministic, cudnn.benchmark))
        return real(detector, params, *args, **kwargs)

    monkeypatch.setattr(port_train, "single_device_test", record)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    root, paths, cfg_file, _ = setup
    runner = train_detector(_config(cfg_file, paths), str(tmp_path / "work"),
                            device="cpu")
    assert runner.refresher is None and runner.epoch == 2
    assert type(runner.data_loader).__name__ == "DetDataLoader"
    # the student, twice, under deterministic cuDNN without autotuning
    assert evaluated == [(None, True, False)] * 2
    assert not torch.backends.cudnn.deterministic
    assert torch.backends.cudnn.benchmark
    lines = _log_lines(tmp_path / "work")
    train = [x for x in lines if x["mode"] == "train"]
    val = [x for x in lines if x["mode"] == "val"]
    assert len(train) == 4 and all(np.isfinite(x["loss"]) for x in train)
    assert [x["epoch"] for x in val] == [1, 2]
    assert all(0.0 <= x["bbox_mAP"] <= 1.0 for x in val)
    ckpt = torch.load(tmp_path / "work" / "epoch_2.pth", weights_only=True)
    assert ckpt["step"] == 4
    student = ckpt["student"]
    assert any(not torch.equal(v, student[k])
               for k, v in ckpt["teacher_params"].items())


@pytest.mark.slow
def test_supervised_train_detector_matches_jax(setup, tmp_path, monkeypatch):
    """Three epochs (six steps) of each package's supervised branch from
    the same weights: every step's losses within 1e-4 and ``grad_norm``
    within 1e-3 relative (the train-step trajectory tests' bounds), the
    student after the last step banded to JAX's (5% of each leaf's largest
    update, floor 1e-6, 1e-3 in L2), the student's ``bbox_mAP`` within
    1e-3. The head is 256 wide, so that each GroupNorm group holds 8
    channels as in the config (``TINY_FILE``'s 64 give groups of 2; see
    ``test_torch_port_modules.py::test_group_norm_grad_on_a_1x1_map``).
    Slow: it compiles the JAX train step and predict."""
    from dsl_tpu.apis.train import train_detector as jax_train_detector

    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import jax_checkpoint_to_torch as conv

    root, paths, cfg_file, _ = setup
    model = {**U.TINY_BASELINE_CFG,
             "bbox_head": {**U.TINY_BASELINE_CFG["bbox_head"],
                           "feat_channels": 256}}
    _, variables = U.jax_detector_and_variables(model, seed=0)
    weights = tmp_path / "weights.pth"
    torch.save(U.port_detector(model, variables).state_dict(), weights)
    # one loader thread: with two the JAX package's threads draw the flips
    # and scales from the global RandomState in the order they run
    cfg = _config(cfg_file, paths, load_from=str(weights),
                  **{"data.workers_per_gpu": 1, "runner.max_epochs": 3,
                     "model.bbox_head.feat_channels": 256})
    jax_train_detector(JaxConfig(cfg.to_dict()), str(tmp_path / "jax"),
                       seed=0, max_devices=1)
    train_detector(cfg, str(tmp_path / "port"), device="cpu")
    got = _log_lines(tmp_path / "port")
    want = _log_lines(tmp_path / "jax")
    got_train = [x for x in got if x["mode"] == "train"]
    assert len(got_train) == len(want) == 6
    for g, w in zip(got_train, want):
        for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness"):
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]) + 1e-5, (k, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-3 * w["grad_norm"], (
            g, w)
    cfg.dump(str(tmp_path / "cfg.py"))
    tree, _ = conv.jax_train_state_tree(str(tmp_path / "cfg.py"),
                                        str(tmp_path / "jax" / "epoch_3"))
    student = torch.load(tmp_path / "port" / "epoch_3.pth",
                         weights_only=True)["student"]
    assert int(tree["step"]) == 6
    U.assert_banded(state_dict_to_flax(student)["params"], tree["params"],
                    init=variables["params"], floor=1e-6)
    # the JAX runner writes its evaluations to train.log only
    text = (tmp_path / "jax" / "train.log").read_text()
    want_map = [float(m) for m in re.findall(
        r"eval epoch \d+: .*?'bbox_mAP': (?:np\.float64\()?([-0-9.e]+)", text)]
    got_map = [x["bbox_mAP"] for x in got if x["mode"] == "val"]
    assert len(got_map) == len(want_map) == 3
    for g, w in zip(got_map, want_map):
        assert abs(g - w) <= 1e-3, (got_map, want_map)


def test_cli_workflow_train_format_only_pseudo_labels(setup, tmp_path,
                                                      capsys):
    """DSL's workflow through the CLIs: train the baseline (from seeded
    weights, ``load_from``), write the
    unlabeled split's detections with ``--format-only``, turn them into
    label files with ``tools/generate_unlabel_annos_coco.py``, read those
    with the port's ``SemiCOCODataset``."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import generate_unlabel_annos_coco as gen
    finally:
        sys.path.remove(str(REPO / "tools"))
    root, paths, cfg_file, weights = setup
    options = [f"{k}={v}" for k, v in _paths_options(paths).items()]
    work = tmp_path / "work"
    runner = train_cli.main([cfg_file, "--work-dir", str(work), "--device",
                             "cpu", "--cfg-options", "runner.max_epochs=1",
                             "evaluation.interval=1", f"load_from={weights}",
                             *options])
    assert runner.epoch == 1
    assert (work / Path(cfg_file).name).exists()      # the dumped config
    ckpt = str(work / "epoch_1.pth")

    out = tmp_path / "unlabeled.bbox.json"
    results, metrics = test_cli.main([
        cfg_file, ckpt, "--format-only", "--out", str(out), "--device", "cpu",
        "--cfg-options", *options, f"data.test.ann_file={paths['unlabeled']}",
        f"data.test.img_prefix={paths['images']}"])
    assert metrics is None and len(results) == 4
    dets = json.load(open(out))
    assert len(dets) == sum(len(d) for d, _ in results) > 0
    assert {"image_id", "bbox", "score", "category_id"} <= set(dets[0])

    store = tmp_path / "pseudo"
    gen.report(str(out), paths["category_info"], paths["unlabeled"],
               str(store), thres=0.0)
    ds = build_dataset(dict(
        type="SemiCOCODataset", ann_file=paths["unlabeled"],
        ann_path=str(store), labelmapper=paths["category_info"],
        img_prefix=paths["images"], pipeline=TRAIN_PIPELINE[:2]),
        "cpu", np.random.RandomState(0), __import__("random").Random(0))
    assert len(ds) == 4
    n_boxes = 0
    for i in range(len(ds)):
        info = ds.data_infos[i]
        label = json.load(open(store / f"{info['filename']}.json"))
        want = U.usable_boxes(label["rects"], info["height"], info["width"])
        assert len(ds[i]["gt_bboxes"]) == len(want)
        n_boxes += len(want)
    assert n_boxes > 0

    _, student = test_cli.main([cfg_file, ckpt, "--device", "cpu",
                                "--eval", "bbox", "--cfg-options", *options])
    _, teacher = test_cli.main([cfg_file, ckpt, "--ema", "--device", "cpu",
                                "--cfg-options", *options])
    for m in (student, teacher):
        assert 0.0 <= m["bbox_mAP"] <= 1.0
    assert "bbox_mAP" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--launcher", "pytorch"],
                                  ["--max-devices", "2"]])
def test_cli_refuses_more_than_one_process_on_one_card(argv, setup,
                                                       monkeypatch):
    """One process drives one card: more cards need a launcher's processes,
    and a launcher's flag needs its environment."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    error = RuntimeError if argv[0] == "--launcher" else ValueError
    with pytest.raises(error, match="torch.distributed.run"):
        train_cli.main([setup[2], "--device", "cpu", *argv])
    if argv[0] == "--launcher":
        with pytest.raises(error, match="torch.distributed.run"):
            test_cli.main([setup[2], "--device", "cpu", *argv])


@pytest.mark.parametrize("metric", ["segm", "proposal"])
def test_test_cli_refuses_an_unported_metric(metric, setup):
    with pytest.raises(NotImplementedError, match=metric):
        test_cli.main([setup[2], "--device", "cpu", "--eval", "bbox", metric])


def test_train_api_registers_the_datasets():
    """In a fresh interpreter, as ``python -m dsl_tpu_torch.tools.train``
    starts: importing the train API registers the datasets it builds."""
    import subprocess

    code = ("import dsl_tpu_torch.apis.train\n"
            "from dsl_tpu_torch.registry import DATASETS\n"
            "assert DATASETS.get('SemiCOCODataset') is not None\n"
            "assert DATASETS.get('CocoDataset') is not None\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
