"""The port's semi-supervised loop against the JAX package's, on the CPU.

- ``LabelStore.update`` and ``compute_adathres`` write byte-identical files
  to the JAX package's for the same detections (fresh, rewritten, fused,
  ``first_ignore``, empty; adathres with and without history);
- the refresh schedule inside ``SemiRunner`` (which files, at which
  iteration, with which score threshold and fuse flags; the first event a
  full refresh) equals the JAX runner's on the same loaders, with both
  refreshers' device work replaced by a recorder;
- one refresh of the JPEG fixtures from the same bridged teacher (the tiny
  flagship) at a resize factor of 0.625: the JAX
  ``PseudoLabelRefresher.refresh_images`` and the port's write the same
  tags and counts, boxes within 1 px (both truncate to integers), scores
  within 1e-3;
- two epochs of ``train_detector`` on a synthetic semicoco directory: every
  unlabeled label file rewritten by the refresher, ``adathres.json``
  written, losses finite, the last checkpoint restored into a fresh state
  bit for bit, and ``resume_from`` continuing from its epoch.
"""

import copy
import json
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.data import datasets as jax_datasets  # noqa: F401 (registers)
from dsl_tpu.data.loader import DetDataLoader as JaxLoader
from dsl_tpu.data.loader import MultiDataLoader as JaxMulti
from dsl_tpu.registry import DATASETS as JAX_DATASETS
from dsl_tpu.registry import build_from_cfg as jax_build
from dsl_tpu.train import label_store as jax_store
from dsl_tpu.train.runner import SemiRunner as JaxRunner
from dsl_tpu.train.semi import PseudoLabelRefresher as JaxRefresher
from dsl_tpu_torch.apis import train_detector
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.data.loader import DetDataLoader, MultiDataLoader
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.train import label_store
from dsl_tpu_torch.train.runner import SemiRunner
from dsl_tpu_torch.train.semi import PseudoLabelRefresher
from dsl_tpu_torch.utils import synthetic_data
from dsl_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

ID2CAT = {"0": "cat", "1": "dog", "2": "car", "3": "bg"}
CAT2ID = {v: int(k) for k, v in ID2CAT.items()}
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=[(96, 64), (96, 48)],
         multiscale_mode="value", keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
]


def _detections(seed: int, n: int):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 120, (n, 2))], 1)
    return (boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32),
            rng.randint(0, 3, n))


# (fuse, first_ignore, a previous file, detections)
STORE_CASES = {
    "fresh": (False, False, False, 40),
    "rewrite": (False, False, True, 40),
    "fuse": (True, False, True, 40),
    "fuse_first_ignore": (True, True, True, 40),
    "empty": (True, False, True, 0),
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_label_store_writes_jax_bytes(tmp_path, case):
    fuse, first_ignore, previous, n = STORE_CASES[case]
    stores = [mod.LabelStore(str(tmp_path / tag), ID2CAT, CAT2ID)
              for tag, mod in (("jax", jax_store), ("port", label_store))]
    for store in stores:
        if previous:
            boxes, scores, cids = _detections(1, 12)
            store.write("a.jpg", boxes.tolist(), [ID2CAT[str(c)] for c in cids],
                        scores, image_rel_name="sub/a.jpg")
        for i in range(2):
            store.update("a.jpg", *_detections(2 + i, n), infer_score_thre=0.2,
                         iou=0.5, fuse=fuse, first_ignore=first_ignore)
    assert (tmp_path / "port" / "a.jpg.json").read_bytes() == (
        tmp_path / "jax" / "a.jpg.json").read_bytes()


@pytest.mark.parametrize("history", [False, True, "empty"])
def test_adathres_writes_jax_bytes(tmp_path, history):
    out = {}
    for tag, mod in (("jax", jax_store), ("port", label_store)):
        store = mod.LabelStore(str(tmp_path / tag), ID2CAT, CAT2ID)
        names = [f"{i}.jpg" for i in range(6)]
        for i, name in enumerate(names):
            store.update(name, *_detections(10 + i, 0 if history == "empty"
                                            else 30), infer_score_thre=0.1)
        path = str(tmp_path / f"{tag}_adathres.json")
        if history is True:
            with open(path, "w") as f:
                json.dump(dict(thres={"cat": 0.5, "dog": 0.2}), f)
        mod.compute_adathres(store, names + ["missing.jpg"], path)
        out[tag] = open(path, "rb").read()
    assert out["port"] == out["jax"]


@pytest.fixture(scope="module")
def semicoco(tmp_path_factory):
    root = tmp_path_factory.mktemp("semicoco")
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    return synthetic_data.make_semicoco_dir(root, sources, 4, 6)


def _ds_cfg(paths, split):
    return dict(type="SemiCOCODataset", ann_file=paths[split],
                ann_path=paths["label_store" if split == "labeled"
                               else "unlabel_store"],
                labelmapper=paths["category_info"], img_prefix=paths["images"],
                pipeline=PIPELINE)


REFRESH_ARGS = dict(start_point=2, preload=1, refresh_batch=2,
                    fuse_history=True, first_score_thre=0.3)


def _recording_jax_runner(paths, tmp, rec):
    np.random.seed(0)
    ds = [jax_build(_ds_cfg(paths, s), JAX_DATASETS)
          for s in ("labeled", "unlabeled")]
    loader = JaxMulti(JaxLoader(ds[0], 2, 1, seed=0, canvas_hw=(64, 96)),
                      JaxLoader(ds[1], 2, 1, seed=1, canvas_hw=(64, 96)),
                      unlabel_weight=3.0, scale_invariant=True)
    ref = JaxRefresher(None, None, paths["images"], ds[1].data_infos,
                       **REFRESH_ARGS)
    ref._get_copy_fn = lambda: (lambda v: v)
    ref._prep_and_dispatch = lambda variables, names: [(list(names), None)]
    ref._write_results = lambda names, _, thre, fuse, ign: rec.append(
        (names, thre, fuse, ign))
    state = types.SimpleNamespace(teacher_variables={})
    return JaxRunner(lambda s, b: (s, {"loss": 0.0}), state, loader,
                     str(tmp / "jax"), max_epochs=4, refresher=ref,
                     checkpoint_interval=100, log_interval=100)


def _recording_port_runner(paths, tmp, rec):
    rng = np.random.RandomState(0)
    ds = [build_from_cfg({**_ds_cfg(paths, s), "device": "cpu", "rng": rng},
                         DATASETS) for s in ("labeled", "unlabeled")]
    loader = MultiDataLoader(DetDataLoader(ds[0], 2, seed=0, canvas_hw=(64, 96)),
                             DetDataLoader(ds[1], 2, seed=1, canvas_hw=(64, 96)),
                             unlabel_weight=3.0, scale_invariant=True)
    ref = PseudoLabelRefresher(torch.nn.Module(), None, paths["images"],
                               ds[1].data_infos, device="cpu", **REFRESH_ARGS)
    ref._predict_all = lambda params, names: [(list(names), None)]
    ref._write_results = lambda names, _, thre, fuse, ign: rec.append(
        (names, thre, fuse, ign))
    state = types.SimpleNamespace(teacher_params={})
    runner = SemiRunner(lambda s, b: {"loss": torch.tensor(0.0)}, state,
                        loader, str(tmp / "port"), max_epochs=4,
                        refresher=ref, checkpoint_interval=100,
                        log_interval=100)
    return runner


def test_refresh_schedule_equals_jax(semicoco, tmp_path):
    """Each refresh the runner completes, in order: file names, score
    threshold, fuse and first_ignore (epochs 2-4 refresh: start_point 2)."""
    got, want = [], []
    _recording_port_runner(semicoco, tmp_path, got).run()
    _recording_jax_runner(semicoco, tmp_path, want).run()
    assert got == want
    # the first event refreshes every unlabeled image at the first score
    # threshold, then one image per iteration
    assert len(got[0][0]) == 6 and got[0][1] == 0.3 and got[0][3] is True
    assert all(len(g[0]) == 1 and g[1] == 0.1 and g[3] is False
               for g in got[1:])
    assert len(got) == 9       # 3 refreshing epochs of 3 iterations


@pytest.fixture(scope="module")
def tiny():
    return U.jax_detector_and_variables(U.TINY_CFG, seed=0)


def test_one_refresh_matches_jax(tiny, tmp_path):
    """The fixtures 640 px wide at img_scale (400, 300), a resize factor of
    0.625: the port's resize is ``cv2.resize``'s bit for bit, so the two
    refreshers predict on the same pixels."""
    det, variables = tiny
    files = sorted(n for n, (_, w, _) in FIXTURES.items() if w == 640)
    names = [f"{n}.jpg" for n in files]
    infos = [dict(filename=f"{n}.jpg", height=FIXTURES[n][0], width=640)
             for n in files]
    cat = json.load(open(_category_info(tmp_path)))
    args = dict(test_cfg=U.TINY_CFG["test_cfg"], canvas_hw=(320, 416),
                img_scale=(400, 300), refresh_batch=3)
    stores = {}
    for tag, mod in (("jax", jax_store), ("port", label_store)):
        stores[tag] = mod.LabelStore(str(tmp_path / tag), cat["id2cat"],
                                     cat["cat2id"])
    JaxRefresher(det, stores["jax"], str(OUT), infos, **args).refresh_images(
        types.SimpleNamespace(teacher_variables=variables), names)
    port = U.port_detector(U.TINY_CFG, variables)
    PseudoLabelRefresher(port, stores["port"], str(OUT), infos, device="cpu",
                         **args).refresh_images(
        types.SimpleNamespace(teacher_params=dict(port.named_parameters())),
        names)
    total = 0
    for name in names:
        got, want = stores["port"].read(name), stores["jax"].read(name)
        assert U.pair_labels(got, want)[0] == 0
        total += got["targetNum"]
    assert total > 0


def test_refresh_holds_one_chunk_of_images(tiny, semicoco, tmp_path):
    """A refresh of more files than ``refresh_batch`` reads each chunk's
    images just before its predict and drops them after: when a chunk is
    predicted, only its own images are alive (the first event of a run
    refreshes the whole unlabeled set, far more than a device holds)."""
    import weakref

    images = json.load(open(semicoco["unlabeled"]))["images"][:5]
    infos = [dict(filename=i["file_name"], height=i["height"],
                  width=i["width"]) for i in images]
    cat = json.load(open(_category_info(tmp_path)))
    store = label_store.LabelStore(str(tmp_path / "store"), cat["id2cat"],
                                   cat["cat2id"])
    port = U.port_detector(U.TINY_CFG, tiny[1])
    ref = PseudoLabelRefresher(port, store, semicoco["images"], infos,
                               test_cfg=U.TINY_CFG["test_cfg"],
                               canvas_hw=(64, 96), img_scale=(96, 64),
                               refresh_batch=2, device="cpu")
    loaded, alive = [], []
    real_load, real_predict = ref._load, ref._predict_chunk

    def load(name):
        out = real_load(name)
        loaded.append(weakref.ref(out[0]))
        return out

    def predict(params, chunk):
        alive.append(sum(r() is not None for r in loaded))
        return real_predict(params, chunk)

    ref._load, ref._predict_chunk = load, predict
    ref.refresh_images(
        types.SimpleNamespace(teacher_params=dict(port.named_parameters())),
        [i["filename"] for i in infos])
    assert len(loaded) == 5 and alive == [2, 2, 1]
    assert all("scores" in store.read(i["filename"]) for i in infos)


def _category_info(tmp_path):
    path = tmp_path / "cats.json"
    cat2id = {c: i for i, c in enumerate(synthetic_data.COCO_CLASSES)}
    cat2id["background"] = 80
    path.write_text(json.dumps(dict(
        cat2id=cat2id, id2cat={str(i): c for c, i in cat2id.items()})))
    return path


def _tiny_semi_cfg(paths) -> dict:
    cfg = Config.fromfile(str(REPO / "configs/fcos_semi/RLA_r50_fcos_semi_dsl.py"))
    cfg = U.cut_flagship(cfg._cfg_dict, max_epochs=2,
                                      start_point=1)
    cfg = synthetic_data.semi_config(cfg, paths)
    cfg["model"] = copy.deepcopy(U.TINY_CFG)
    cfg["canvas_hw"] = (64, 96)
    for key in ("train", "unlabel_train"):
        cfg["data"][key]["pipeline"] = PIPELINE
    cfg["data"]["unlabel_pred"]["pipeline"][1]["img_scale"] = (96, 64)
    cfg["log_config"] = dict(interval=1)
    return cfg


def test_two_epochs_of_train_detector(tmp_path, tiny):
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    paths = synthetic_data.make_semicoco_dir(tmp_path / "data", sources, 2, 4)
    before = U.tree_of(paths["unlabel_store"])
    cfg = _tiny_semi_cfg(paths)
    runner = train_detector(Config(cfg), str(tmp_path / "work"), device="cpu",
                            variables=tiny[1])
    after = U.tree_of(paths["unlabel_store"])
    assert set(after) == set(before)
    for name, data in after.items():
        assert data != before[name] and "scores" in json.loads(data), name
    ada = json.load(open(paths["adathres"]))
    assert ada["thres"] and set(ada) == {"cat", "id", "thres"}
    losses = runner.log_buffer.history["loss"]
    assert len(losses) == 4 and all(np.isfinite(float(v)) for v in losses)
    # the metrics reach the host at each log line: no tensor is kept
    assert all(type(x) is float for v in runner.log_buffer.history.values()
               for x in v)
    assert (tmp_path / "work" / "latest").resolve().name == "epoch_2.pth"
    assert (tmp_path / "work" / "train.log.json").read_text().count("\n") == 4

    # the last checkpoint, restored into a fresh state: every tensor and
    # counter equal to the final state's
    state = runner.state
    fresh = train_detector(Config(dict(cfg, runner=dict(cfg["runner"],
                                                        max_epochs=0))),
                           str(tmp_path / "fresh"), device="cpu",
                           variables=tiny[1]).state
    assert fresh.step == 0
    loaded, meta = load_checkpoint(str(tmp_path / "work" / "epoch_2.pth"), fresh)
    assert meta == {"epoch": 2}
    assert (loaded.step, loaded.opt_count, loaded.ema_initialized) == (
        state.step, state.opt_count, state.ema_initialized) == (4, 4, True)
    assert torch.equal(loaded.ema_ratio, state.ema_ratio)
    for a, b in ((loaded.student.state_dict(), state.student.state_dict()),
                 (loaded.teacher_params, state.teacher_params)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    moms = [(loaded.optimizer.state[p], state.optimizer.state[q]) for p, q in zip(
        loaded.student.parameters(), state.student.parameters()) if p.requires_grad]
    assert moms and all(torch.equal(x["momentum_buffer"], y["momentum_buffer"])
                        for x, y in moms)
    # resume_from continues from the epoch the checkpoint holds
    resumed = train_detector(Config(cfg), str(tmp_path / "resumed"),
                             resume_from=str(tmp_path / "work" / "epoch_2.pth"),
                             device="cpu", variables=tiny[1])
    assert resumed.epoch == 2 and resumed.state.step == 4
    got = resumed.state.student.state_dict()
    assert all(torch.equal(v, state.student.state_dict()[k])
               for k, v in got.items())
    shutil.rmtree(tmp_path / "data")


@pytest.mark.slow
def test_semicoco_run_writes_the_label_files_of_jax(tmp_path, tiny):
    """Two epochs of each package's ``train_detector`` on one synthetic
    semicoco directory from the same weights give the same label files
    (paired: tags and counts equal, boxes within 1 px, scores within 1e-3)
    and adathres thresholds within 1e-3. The learning rate is 0, so the
    teacher stays the shared weights, and the 640 px wide fixtures are
    trained and refreshed at their own scale, so both resizes copy the
    decoded pixels. About a minute: it compiles the JAX train step and
    predict at 480x640."""
    from dsl_tpu.apis.train import train_detector as jax_train_detector
    from dsl_tpu.config import Config as JaxConfig

    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()
               if w == 640]
    runs = {}
    for tag in ("jax", "port"):
        paths = synthetic_data.make_semicoco_dir(tmp_path / tag, sources, 2, 4)
        cfg = _tiny_semi_cfg(paths)
        cfg["canvas_hw"] = (480, 640)
        cfg["optimizer"]["lr"] = 0.0
        for key in ("train", "unlabel_train"):
            cfg["data"][key]["pipeline"][2] = dict(
                type="Resize", img_scale=(640, 480), keep_ratio=True)
        cfg["data"]["unlabel_pred"]["pipeline"][1]["img_scale"] = (640, 480)
        if tag == "jax":
            weights = tmp_path / "weights.pth"
            torch.save(U.port_detector(U.TINY_CFG, tiny[1]).state_dict(), weights)
            jax_train_detector(JaxConfig(dict(cfg, load_from=str(weights))),
                               str(tmp_path / "jax_work"), seed=0, max_devices=1)
        else:
            train_detector(Config(cfg), str(tmp_path / "port_work"),
                           device="cpu", variables=tiny[1])
        runs[tag] = paths
    names = sorted(U.tree_of(runs["jax"]["unlabel_store"]))
    total = 0
    for name in names:
        got, want = (json.loads(open(f"{runs[t]['unlabel_store']}/{name}").read())
                     for t in ("port", "jax"))
        assert "scores" in got and "scores" in want
        assert U.pair_labels(got, want)[0] == 0
        total += got["targetNum"]
    assert total > 0
    ada = {t: json.load(open(runs[t]["adathres"]))["thres"] for t in runs}
    assert ada["port"].keys() == ada["jax"].keys()
    assert all(abs(ada["port"][k] - ada["jax"][k]) <= 1e-3 for k in ada["jax"])
