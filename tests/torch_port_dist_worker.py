"""What each rank runs in the port's data-parallel checks
(``tests/test_torch_port_dist.py``, and ``chip_smoke.py`` phase 15 on the
card). It imports no JAX, so the card's machine can run it.

:func:`rank_main` is the target of ``torch.multiprocessing.spawn``: the
rank joins a gloo group at ``init_method``, runs the named tasks, writes
its results to ``out/rank_<r>.pt`` and leaves the group. The tasks:

- ``step``: one train step of the flagship (its width and depth from
  ``width``, :func:`model_cfg`) on
  this rank's shard of the seeded global batch (:func:`shards`), the loss
  normalizers and gradients summed over the ranks; its metrics, its
  parameters' and teacher's sha256, and (rank 0) its parameters, for
  :func:`compare_step` against a one-process step on the global batch
  (:func:`reference_step`);
- ``refresh``: the pseudo-label refresh of a file list with the seeded
  teacher, chunk ``c`` by rank ``c mod W``, into a shared label store; the
  names this rank wrote;
- ``evaluate``: ``single_device_test`` over a val set, batches split by
  rank; the gathered results and (rank 0) the metrics;
- ``loader``: an epoch of ``MultiDataLoader(n_shards=W, rank=r)`` over
  :class:`ShapesDataset` (landscape and portrait images, so the canvas
  vote matters); each batch's rows;
- ``train``: ``train_detector`` on a config, then (optionally) a refresh
  and an evaluation of its teacher split over the ranks (:func:`run_train`).
"""

from __future__ import annotations

import copy
import hashlib
import os
import random
from pathlib import Path

import numpy as np
import torch

import torch_port_util as U

REFRESH_BATCH = 2
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def model_cfg(width: str) -> dict:
    """The flagship: ``"tiny"`` (``TINY_CFG``), ``"full"``, or ``"full_d1"``
    (full width at RLA depth [1, 1, 1, 1])."""
    if width == "tiny":
        return copy.deepcopy(U.TINY_CFG)
    cfg = U.full_cfg()
    if width == "full_d1":
        cfg["backbone"]["layers"] = [1, 1, 1, 1]
    return cfg


def seeded_variables(width: str) -> dict:
    """Seeded flax-layout weights of the flagship (tiny or full width)."""
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax
    from dsl_tpu_torch.utils.random_weights import fill_variables

    return fill_variables(state_dict_to_flax(
        empty_detector(model_cfg(width)).state_dict()))


def seeded_detector(width: str, variables: str | None = None):
    """The flagship with seeded weights, or those saved at ``variables``
    (a flax-layout tree, ``torch.save``'d)."""
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict

    det = empty_detector(model_cfg(width))
    tree = (seeded_variables(width) if variables is None
            else torch.load(variables, weights_only=False))
    det.load_state_dict(flax_to_state_dict(tree))
    return det


def train_entry(width: str, device, group, variables: str | None = None):
    """(state, step) of the flagship's training entry point, the schedule
    of ``configs/_base_/schedules/schedule_semi.py``."""
    from dsl_tpu_torch.train import (
        build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
        make_train_step)

    det = seeded_detector(width, variables)
    frozen = frozen_backbone_mask(det, model_cfg(width)["backbone"]["frozen_stages"])
    tx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                     U.LR_CONFIG, steps_per_epoch=U.STEPS_PER_EPOCH)
    state = create_train_state(det, tx, ema_ratio=0.99, device=device)
    step = make_train_step(det, tx, ema_interval=1, ema_start_iter=1,
                           frozen_mask=frozen, device=device, group=group)
    return state, step


def shards(world: int, canvas, per_source: int = 2) -> list[dict]:
    """``world`` seeded shards of the global batch (numpy, the data layer's
    layout), each ``per_source`` labeled and as many unlabeled images (2 and
    2: the flagship's per-GPU mix), then the half-res copy of the last one
    (the si pair): shard ``s`` from seed ``s``, 1-20 GT boxes per image, no
    ignore box on a labeled image and 0-10 on an unlabeled one, unlabeled
    images weighted 3 (the flagship head's ``loss_weight``)."""
    from dsl_tpu_torch.utils.random_batch import semi_batch

    out = []
    for s in range(world):
        rng = np.random.RandomState(1000 + s)
        side = (max(4, min(canvas) // 16), max(8, min(canvas) // 2))
        out.append(semi_batch(
            s, canvas, n_gt=list(rng.randint(1, 21, 2 * per_source)),
            n_ignore=[0] * per_source + list(rng.randint(0, 11, per_source)),
            n_labeled=per_source, side=side))
    return out


def global_batch(parts: list[dict]) -> dict:
    """The shards one after another, each keeping its half-res copy after
    it, and ``si_pair`` holding one index per shard: the global batch of
    ``build_batch(n_shards=len(parts))``."""
    out = {k: np.concatenate([p[k] for p in parts])
           for k in parts[0] if k != "si_pair"}
    rows = len(parts[0]["images"])
    out["si_pair"] = {k: np.concatenate([p["si_pair"][k] + s * rows
                                         for s, p in enumerate(parts)])
                      for k in ("full", "half")}
    return out


def run_step(width: str, batch: dict, device, group, variables=None):
    """One step from the seeded state: metrics as floats, the trainable
    parameters before and after, the teacher after (on the CPU)."""
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.utils.random_batch import to_torch

    state, step = train_entry(width, device, group, variables)
    before = {n: p.detach().cpu().clone()
              for n, p in state.student.named_parameters() if p.requires_grad}
    with deterministic_cudnn():
        metrics = step(state, to_torch(batch, device))
    metrics = {k: float(v) for k, v in metrics.items()}
    after = {n: p.detach().cpu().clone()
             for n, p in state.student.named_parameters() if p.requires_grad}
    teacher = {n: t.detach().cpu().clone() for n, t in state.teacher_params.items()}
    return metrics, before, after, teacher


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].numpy().tobytes())
    return h.hexdigest()


def reference_step(width: str, world: int, canvas, device, per_source: int = 2,
                   variables=None) -> dict:
    """One process on the global batch: metrics, the parameters before and
    after, the teacher after."""
    metrics, before, after, teacher = run_step(
        width, global_batch(shards(world, canvas, per_source)), device, None,
        variables)
    return dict(metrics=metrics, before=before, after=after,
                teacher_sha=digest(teacher))


def compare_step(got: dict, after: dict, want: dict) -> dict:
    """Worst relative difference of the metrics, and of each parameter's
    update band (per parameter ``|got - want| / max(|update|, 1e-5 *
    max(|p|, 1))``, as ``chip_smoke.py`` bands the card against the CPU)."""
    rel = max(abs(got[k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-12)
              for k in want["metrics"])
    band = 0.0
    for n, w in want["after"].items():
        update = (w - want["before"][n]).abs().max().item()
        floor = 1e-5 * max(w.abs().max().item(), 1.0)
        band = max(band, (after[n] - w).abs().max().item() / max(update, floor))
    return dict(metrics_rel=rel, update_band=band)


def task_step(rank, world, device, group, width, canvas, per_source=2,
              variables=None, timed: int = 0):
    """The step on this rank's shard; with ``timed``, that many more steps
    after two warm-ups, each ending in a synchronize: their median ms."""
    import time

    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.utils.random_batch import to_torch

    batch = shards(world, canvas, per_source)[rank]
    with deterministic_cudnn():
        state, step = train_entry(width, device, group, variables)
        tb = to_torch(batch, device)
        metrics = {k: float(v) for k, v in step(state, tb).items()}
        after = {n: p.detach().cpu().clone()
                 for n, p in state.student.named_parameters() if p.requires_grad}
        teacher = {n: t.detach().cpu().clone()
                   for n, t in state.teacher_params.items()}
        times = []
        for i in range(timed + 2 if timed else 0):
            t0 = time.perf_counter()
            step(state, tb)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
    return dict(metrics=metrics, params_sha=digest(after),
                teacher_sha=digest(teacher), after=after if rank == 0 else None,
                step_ms=sorted(times)[len(times) // 2] if times else None)


def refresher(det, paths: dict, store_dir: str, device, group, img_scale,
              canvas):
    """The flagship's refresher over ``paths`` (``make_semicoco_dir``'s),
    writing into ``store_dir``, ``REFRESH_BATCH`` images per chunk."""
    import json

    from dsl_tpu_torch.train.label_store import LabelStore
    from dsl_tpu_torch.train.semi import PseudoLabelRefresher

    with open(paths["category_info"], encoding="utf-8") as f:
        cats = json.load(f)
    with open(paths["unlabeled"], encoding="utf-8") as f:
        infos = [dict(filename=i["file_name"], width=i["width"],
                      height=i["height"]) for i in json.load(f)["images"]]
    store = LabelStore(store_dir, cats["id2cat"], cats["cat2id"])
    return PseudoLabelRefresher(
        det, store, image_root=paths["images"], image_infos=infos,
        test_cfg=det.test_cfg, canvas_hw=canvas, img_scale=img_scale,
        refresh_batch=REFRESH_BATCH, device=device, group=group), infos


def run_refresh(width, paths, store_dir, device, group, img_scale, canvas):
    """Refresh every unlabeled image once with the seeded teacher; the
    names this process wrote."""
    from types import SimpleNamespace

    det = seeded_detector(width).to(device)
    ref, infos = refresher(det, paths, store_dir, device, group, img_scale,
                           canvas)
    written = []
    update = ref.store.update

    def recording(name, *args, **kwargs):
        written.append(name)
        return update(name, *args, **kwargs)

    ref.store.update = recording
    state = SimpleNamespace(teacher_params=dict(det.named_parameters()))
    ref.refresh_images(state, [i["filename"] for i in infos])
    return written


def val_dataset(paths: dict, device, img_scale):
    from dsl_tpu_torch.apis.train import build_dataset

    return build_dataset(dict(
        type="CocoDataset", ann_file=paths["val"], img_prefix=paths["val_images"],
        test_mode=True, pipeline=[
            dict(type="LoadImageFromFile"),
            dict(type="MultiScaleFlipAug", img_scale=img_scale, flip=False,
                 transforms=[dict(type="Resize", keep_ratio=True),
                             dict(type="RandomFlip"),
                             dict(type="Normalize", **NORM),
                             dict(type="Pad", size_divisor=32)])]),
        device, np.random.RandomState(0), random.Random(0))



def run_evaluate(width, paths, device, group, img_scale, canvas):
    """``single_device_test`` of the seeded detector over the val set:
    (metrics or None, per-image results)."""
    from dsl_tpu_torch.apis.test import single_device_test

    det = seeded_detector(width).to(device).eval()
    return single_device_test(
        det, None, val_dataset(paths, device, img_scale), test_cfg=det.test_cfg,
        canvas_hw=canvas, img_scale=img_scale, img_norm=NORM,
        return_results=True, device=device, group=group)


class ShapesDataset:
    """``n`` samples whose image ``i`` is filled with ``i`` (landscape
    40x60 or portrait 60x40 by a seeded flag) with one GT box at ``i``;
    records the indices it is asked for. ``torch`` gives tensors (the
    port's pipeline output), else numpy (the JAX package's)."""

    def __init__(self, n: int, seed: int, torch_images: bool = True):
        self.flag = np.random.RandomState(seed).randint(0, 2, n).astype(np.uint8)
        self.torch_images = torch_images
        self.calls = []

    def __len__(self):
        return len(self.flag)

    def __getitem__(self, i):
        self.calls.append(int(i))
        hw = (40, 60) if self.flag[i] else (60, 40)
        img = np.full((*hw, 3), float(i), np.float32)
        return dict(img=torch.from_numpy(img) if self.torch_images else img,
                    gt_bboxes=np.asarray([[i, 1, i + 4, 5]], np.float32),
                    gt_labels=np.asarray([i % 80]))


def multi_loader(n_shards: int, rank, torch_images: bool = True, jax=False):
    """The labeled (10 samples) and unlabeled (14) loaders of
    :class:`ShapesDataset` merged 2:2 per shard with the half-res copy, on
    a (64, 96) canvas; the JAX package's with ``jax``."""
    if jax:
        from dsl_tpu.data.loader import DetDataLoader, MultiDataLoader

        lab = DetDataLoader(ShapesDataset(10, 1, False), 2, 1,
                            canvas_hw=(64, 96), seed=0)
        unl = DetDataLoader(ShapesDataset(14, 2, False), 2, 1,
                            canvas_hw=(64, 96), seed=1)
        return MultiDataLoader(lab, unl, unlabel_weight=3.0,
                               scale_invariant=True, n_shards=n_shards)
    from dsl_tpu_torch.data.loader import DetDataLoader, MultiDataLoader

    lab = DetDataLoader(ShapesDataset(10, 1), 2, canvas_hw=(64, 96), seed=0)
    unl = DetDataLoader(ShapesDataset(14, 2), 2, canvas_hw=(64, 96), seed=1)
    return MultiDataLoader(lab, unl, unlabel_weight=3.0, scale_invariant=True,
                           n_shards=n_shards, rank=rank)


def batch_rows(batch: dict) -> dict:
    """A batch's arrays on the host (images, boxes, weights, si pair)."""
    out = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
           for k, v in batch.items() if k not in ("meta", "si_pair")}
    out["si_pair"] = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                      for k, v in batch["si_pair"].items()}
    return out


def run_loader(rank, world):
    return [batch_rows(b) for b in multi_loader(world, rank)]


def evaluate_teacher(cfg, runner, device, group):
    """``single_device_test`` of the runner's teacher over the config's
    val set, as its evaluation runs: (metrics or None, results)."""
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.apis.train import build_dataset, pipeline_generators
    from dsl_tpu_torch.data.pipelines import test_pipeline_params

    val = dict(cfg.data.val)
    tp = test_pipeline_params(val.get("pipeline"))
    return single_device_test(
        runner.state.student, runner.state.teacher_params,
        build_dataset({**val, "test_mode": True}, device, *pipeline_generators(0)),
        test_cfg=dict(cfg.model.get("test_cfg", {}) or {}),
        canvas_hw=tuple(cfg.canvas_hw), img_scale=tp["img_scale"],
        img_norm=tp["img_norm"], return_results=True, device=device, group=group)


def run_train(cfg: str, work_dir: str, device, refresh_after: bool = False):
    """``train_detector`` on a config (a json file) with seeded weights for
    its model; then, with ``refresh_after``, one refresh of every
    unlabeled image from the final teacher and one evaluation of it.
    Returns the final step, the student's sha256, the refresh's first
    chunk number and the names this rank wrote in it, the evaluation
    (metrics on rank 0, the results), and this process's NMS launches."""
    import json
    from types import SimpleNamespace

    from dsl_tpu_torch.apis.train import train_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import build_detector
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax
    from dsl_tpu_torch.utils.random_weights import fill_variables

    with open(cfg, encoding="utf-8") as f:
        cfg = Config(json.load(f))
    variables = fill_variables(state_dict_to_flax(
        build_detector(dict(cfg.model)).state_dict()))
    runner = train_detector(cfg, work_dir, device=device, variables=variables)
    out = dict(step=runner.state.step, student_sha=digest(
        {k: v.detach().cpu() for k, v in runner.state.student.state_dict().items()}))
    if refresh_after:
        ref = runner.refresher
        written = []
        update = ref.store.update
        ref.store.update = lambda name, *a, **k: (written.append(name),
                                                 update(name, *a, **k))[1]
        first = ref._chunks
        ref.refresh_images(SimpleNamespace(teacher_params=runner.state.teacher_params),
                           [i["filename"] for i in ref.image_infos])
        from dsl_tpu_torch.apis.train import deterministic_cudnn
        from dsl_tpu_torch.parallel import dist

        with deterministic_cudnn():
            out.update(first_chunk=first, written=written,
                       evaluation=evaluate_teacher(cfg, runner, device,
                                                   dist.group()))
    out["nms_launches"] = nms_keep.launches
    return out


def rank_main(rank: int, world: int, init_method: str, device: str,
              tasks: list, out: str, threads: int = 2) -> None:
    from dsl_tpu_torch.parallel import dist

    torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    group = dist.init_group("gloo", init_method, rank, world)
    results = {}
    for name, kw in tasks:
        if name == "step":
            results[name] = task_step(rank, world, device, group, **kw)
        elif name == "refresh":
            results[name] = run_refresh(device=device, group=group, **kw)
        elif name == "evaluate":
            results[name] = run_evaluate(device=device, group=group, **kw)
        elif name == "loader":
            results[name] = run_loader(rank, world)
        elif name == "train":
            results[name] = run_train(device=device, **kw)
        else:
            raise ValueError(f"unknown task {name}")
    torch.save(results, os.path.join(out, f"rank_{rank}.pt"))
    dist.barrier()
    dist.destroy()


def spawn(world: int, tmp: Path, device: str, tasks: list, threads: int = 2):
    """Start ``tasks`` on ``world`` spawned ranks (a ``file://`` store under
    ``tmp``); :func:`collect` waits for them."""
    import torch.multiprocessing as mp

    return mp.spawn(rank_main, args=(world, f"file://{tmp / 'store'}", device,
                                     tasks, str(tmp), threads),
                    nprocs=world, join=False)


def collect(ranks, world: int, tmp: Path) -> list[dict]:
    """Wait for the spawned ranks; each rank's results."""
    while not ranks.join():
        pass
    return [torch.load(tmp / f"rank_{r}.pt", weights_only=False)
            for r in range(world)]
