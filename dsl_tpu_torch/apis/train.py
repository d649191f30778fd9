"""train_detector: config -> datasets -> loaders -> train step -> runner.

Counterpart of ``dsl_tpu/apis/train.py``: ``build_detector`` -> the
weights (the modules' init from ``seed``, a ``pretrained`` backbone file
loaded by the backbone's ``init_weights``, then ``load_from``, both through
``utils/torch_import.py``) -> ``frozen_backbone_mask`` ->
``build_optimizer_from_cfg`` (``steps_per_epoch`` = the loader's length) ->
``create_train_state`` (the EMA teacher, kept in both branches as the JAX
package keeps it) -> ``make_train_step`` (bf16 when ``cfg.fp16``), then
:class:`SemiRunner`. Two branches, as there:

- semi-supervised (the config has ``data.unlabel_train``): the
  ``MultiDataLoader`` of ``data.train`` and ``data.unlabel_train``, the
  pseudo-label refresher of ``data.unlabel_pred`` with ``adathres_file``
  from ``unlabel_train.thres``, and the evaluation of ``data.val`` on the
  EMA teacher's parameters (the state's teacher dict through
  ``detector_predict``, no second model);
- supervised (DSL's baseline, no ``unlabel_train``): the labeled loader
  alone, no refresher, and the evaluation on the student.

Data parallelism: where a process group of ``W`` ranks is joined
(``parallel.dist.init_dist``, as ``tools/train.py --launcher`` does), each
rank trains on its card (the current one) with the JAX mesh's global-batch
semantics: rank ``r`` loads shard ``r`` of each global batch (the semi
branch's ``W`` shards of the per-GPU mix; the supervised branch's
``samples_per_gpu`` split ``W`` ways, as the JAX package splits it), the
parameters start as rank 0's (a broadcast), the step sums its loss
normalizers and gradients over the ranks, the refresh and the evaluation
are split by chunk and by batch, and rank 0 writes the logs and
checkpoints. The pipelines' random draws are per rank: rank ``r > 0``
draws from ``RandomState([seed, r])`` and ``Random(f"{seed}:{r}")``; rank 0
from the seed itself, as one process does. With one rank (no group)
nothing of this runs.

One device, CUDA unless the caller passes ``device="cpu"``. While the
runner runs, cuDNN is held to its deterministic algorithms
(:func:`deterministic_cudnn`), so one seed gives one model, as in the JAX
package; its nondeterministic backward algorithms made the f32 step part
run to run. The process's flags come back when ``train_detector`` returns.
A detector with a top-level ``bbox_head`` whose loss is ``SeesawLoss``
(Mask R-CNN's) trains with a :class:`SeesawCounter` of the classes
(``with_seesaw_counts``): before each step the batch's valid GT labels are
added to it and the counts reach the loss as ``batch["cum_samples"]``, as
in the JAX package. A cascade has ``bbox_heads`` and no ``bbox_head``
there, so its loop keeps no counter and each stage's SeesawLoss reads
counts of one; so does the port's. Not ported yet, and refused with ``NotImplementedError``:
Dynamic R-CNN and the other two-stage variants (``build_detector`` names
them), the GHM losses, SeesawLoss under data parallelism (each rank would
count its own shard; the JAX package counts the global batch), and for a
two-stage detector (Faster R-CNN) ``fp16`` (its loss runs in f32, as in
the JAX package, which ignores the dtype there) and data parallelism. A
weight file that fails to load raises, where the JAX package warns and
trains from its init. ``variables`` (a flax-layout
tree, through the weight bridge) replaces the init and the ``pretrained``
file. The pipelines draw from one ``np.random.RandomState(seed)`` and one
``random.Random(seed)``, as the JAX package's draw from the global
``np.random`` and Python's ``random`` after ``set_random_seed(seed)``
seeds both.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os.path as osp
import random

import numpy as np
import torch

from dsl_tpu_torch.apis.test import single_device_test
from dsl_tpu_torch.core.losses import SeesawCounter
from dsl_tpu_torch.data import datasets  # noqa: F401 (registers the datasets)
from dsl_tpu_torch.data.formatting import DEFAULT_CANVAS
from dsl_tpu_torch.data.loader import DetDataLoader, MultiDataLoader
from dsl_tpu_torch.data.pipelines import test_pipeline_params
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.cascade_rcnn import roi_bbox_head_cfg
from dsl_tpu_torch.models.detectors.two_stage import check_two_stage
from dsl_tpu_torch.parallel import dist
from dsl_tpu_torch.parallel.mesh import broadcast_state
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.train import (
    build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
    make_train_step)
from dsl_tpu_torch.train.label_store import LabelStore
from dsl_tpu_torch.train.runner import SemiRunner
from dsl_tpu_torch.train.semi import PseudoLabelRefresher
from dsl_tpu_torch.utils.device import resolve_device
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict
from dsl_tpu_torch.utils.logger import get_root_logger
from dsl_tpu_torch.utils.torch_import import load_torch_detector

DEFAULT_NORM = dict(mean=(123.675, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375), to_rgb=True)


def _seesaw_classes(model_cfg: dict) -> int | None:
    """The class count of the detector's top-level bbox head where its loss
    is SeesawLoss, else None: the head the JAX package's ``train_detector``
    reads (``detector.bbox_head``), which a cascade or a multi-head
    detector (``bbox_heads``) does not have."""
    if model_cfg.get("bbox_heads"):
        return None
    head = dict(model_cfg.get("bbox_head") or {})
    if dict(head.get("loss_cls", {}) or {}).get("type") == "SeesawLoss":
        return int(head["num_classes"])
    return None


def _refuse_unported(cfg, group=None):
    if cfg.model.get("type") == "DynamicRCNN":
        raise NotImplementedError("Dynamic R-CNN is not ported yet")
    if group is not None and _seesaw_classes(cfg.model) is not None:
        raise NotImplementedError(
            "SeesawLoss under data parallelism: the JAX package counts the "
            "global batch's labels, a rank sees its shard's")
    if "rpn_head" in cfg.model:
        check_two_stage(torch.bfloat16 if cfg.get("fp16") else None, group)
    head = roi_bbox_head_cfg(cfg.model)
    for key in ("loss_cls", "loss_bbox"):
        kind = dict(head.get(key, {}) or {}).get("type")
        if kind in ("GHMC", "GHMR"):
            raise NotImplementedError(f"{kind} is not ported yet")


def with_seesaw_counts(train_step, num_classes: int, device):
    """``train_step`` behind a :class:`SeesawCounter` on ``device``: each
    batch's valid GT labels counted, then ``batch["cum_samples"]`` set to
    the counts, before the step. The counter is the wrapper's
    ``counter``."""
    counter = SeesawCounter(num_classes, device)

    def step(state, batch, **kw):
        counter.update(batch["gt_labels"], batch.get("gt_valid"))
        return train_step(state, dict(batch, cum_samples=counter.counts), **kw)

    step.counter = counter
    return step


def _check_num_classes(cfg, dataset, logger):
    """NumClassCheckHook: warn where the head's ``num_classes`` (a
    cascade's last stage's) is not the dataset's number of classes."""
    head_nc = roi_bbox_head_cfg(cfg.model).get("num_classes")
    classes = getattr(dataset, "CLASSES", None)
    if head_nc is not None and classes and len(classes) != head_nc:
        logger.warning("num_classes mismatch: head has %d but dataset %s has "
                       "%d classes", head_nc, type(dataset).__name__,
                       len(classes))


def build_dataset(cfg: dict, device, rng, pyrng):
    return build_from_cfg({**dict(cfg), "device": device, "rng": rng,
                           "pyrng": pyrng}, DATASETS)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms, with no autotuning, for
    the block; the process's own flags come back after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def pipeline_generators(seed: int, rank: int = 0):
    """The pipelines' ``np.random.RandomState`` and ``random.Random`` for
    a rank: the seed's own at rank 0, ``(seed, rank)``'s elsewhere."""
    if rank == 0:
        return np.random.RandomState(seed), random.Random(seed)
    return np.random.RandomState([seed, rank]), random.Random(f"{seed}:{rank}")


def train_detector(cfg, work_dir: str, resume_from: str | None = None,
                   seed: int = 0, device: str | torch.device = "cuda",
                   variables: dict | None = None) -> SemiRunner:
    """Train the config's detector; returns the runner after its last
    epoch (its ``state`` holds the result)."""
    device = resolve_device(device)
    group = dist.group()
    _refuse_unported(cfg, group)
    rank, world = dist.get_rank(), dist.get_world_size()
    shard = rank if group is not None else None
    logger = (get_root_logger(log_file=osp.join(work_dir, "train.log"))
              if rank == 0 else get_root_logger(log_level=logging.ERROR))
    rng, pyrng = pipeline_generators(seed, rank)
    torch.manual_seed(seed)

    detector = build_detector(dict(cfg.model))
    if variables is None:
        detector.init_weights(torch.Generator().manual_seed(seed))
    else:
        detector.load_state_dict(flax_to_state_dict(variables))
    if cfg.get("load_from"):
        load_torch_detector(cfg.load_from, detector)

    canvas = tuple(cfg.get("canvas_hw") or DEFAULT_CANVAS)
    data_cfg = cfg.data
    spg = data_cfg.get("samples_per_gpu", 2)
    train_ds = build_dataset(data_cfg["train"], device, rng, pyrng)
    _check_num_classes(cfg, train_ds, logger)
    semi = "unlabel_train" in data_cfg
    label_loader = DetDataLoader(train_ds, spg, canvas_hw=canvas, seed=seed,
                                 n_shards=1 if semi else world,
                                 rank=None if semi else shard)
    if semi:
        unlabel_ds = build_dataset(data_cfg["unlabel_train"], device, rng,
                                   pyrng)
        ratio = data_cfg.get("batch_config", {}).get("ratio", [[1, 1]])[0]
        data_loader = MultiDataLoader(
            label_loader,
            DetDataLoader(unlabel_ds, spg, canvas_hw=canvas, seed=seed + 1),
            ratio=ratio,
            unlabel_weight=cfg.model.get("bbox_head", {}).get("loss_weight",
                                                              1.0),
            scale_invariant=bool(cfg.get("scale_invariant", False)),
            n_shards=world, rank=shard)
    else:
        data_loader = label_loader

    runner_cfg = dict(cfg.get("runner", {}) or {})
    max_epochs = runner_cfg.get("max_epochs", 12)
    frozen = frozen_backbone_mask(
        detector, cfg.model.get("backbone", {}).get("frozen_stages", -1))
    tx, _ = build_optimizer_from_cfg(
        dict(cfg.optimizer),
        optimizer_config=dict(cfg.get("optimizer_config", {}) or {}),
        lr_config=dict(cfg.get("lr_config", {}) or {}),
        steps_per_epoch=len(data_loader), total_epochs=max_epochs,
        momentum_config=dict(cfg.get("momentum_config", {}) or {}) or None)
    ema_cfg = dict(cfg.get("ema_config", {}) or {})
    state = create_train_state(detector, tx,
                               ema_ratio=ema_cfg.get("ratio", 0.99),
                               device=device)
    broadcast_state([*detector.parameters(), *detector.buffers(),
                     *state.teacher_params.values()], group)
    compute_dtype = torch.bfloat16 if cfg.get("fp16") else None
    train_step = make_train_step(
        detector, tx,
        ema_interval=(ema_cfg.get("interval", 1)
                      if ema_cfg.get("mode", "iteration") == "iteration" else -1),
        ema_start_iter=ema_cfg.get("start_point", 1),
        compute_dtype=compute_dtype, frozen_mask=frozen, device=device,
        group=group)
    if _seesaw_classes(cfg.model) is not None:
        train_step = with_seesaw_counts(train_step,
                                        _seesaw_classes(cfg.model), device)

    refresher, adathres_file = None, None
    if semi and "unlabel_pred" in data_cfg:
        up = dict(data_cfg["unlabel_pred"])
        with open(up["category_info_path"], "r", encoding="utf-8") as f:
            cat_info = json.load(f)
        store = LabelStore(up["anno_root_path"], cat_info["id2cat"],
                           cat_info["cat2id"])
        ec = dict(up.get("eval_checkpoint_config", {}) or {})
        tp = test_pipeline_params(up.get("pipeline"))
        refresher = PseudoLabelRefresher(
            detector, store,
            image_root=up.get("image_root_path", up.get("img_path", "")),
            image_infos=unlabel_ds.data_infos,
            test_cfg=dict(cfg.model.get("test_cfg", {}) or {}),
            canvas_hw=canvas, img_scale=tp["img_scale"],
            img_norm=tp["img_norm"] or DEFAULT_NORM,
            infer_score_thre=up.get("infer_score_thre", 0.1),
            iou=up.get("eval_config", {}).get("iou", [0.6])[0],
            fuse_history=up.get("fuse_history", False),
            first_fuse=up.get("first_fuse", False),
            first_score_thre=up.get("first_score_thre", 0.1),
            use_ema=up.get("use_ema", True),
            eval_flip=up.get("eval_flip", False),
            mode=ec.get("mode", "iteration"),
            interval=ec.get("interval", 1),
            start_point=up.get("start_point", 8),
            preload=up.get("preload", 6), device=device, group=group)
        thres = data_cfg["unlabel_train"].get("thres")
        if isinstance(thres, str):
            adathres_file = thres

    eval_fn = None
    evaluation = dict(cfg.get("evaluation", {}) or {})
    if "val" in data_cfg and evaluation:
        val_ds = build_dataset({**dict(data_cfg["val"]), "test_mode": True},
                               device, rng, pyrng)
        tp = test_pipeline_params(dict(data_cfg["val"]).get("pipeline"))
        test_cfg = dict(cfg.model.get("test_cfg", {}) or {})

        def eval_fn(state):
            # the teacher where there is one to evaluate, else the student
            # (None: the detector's own parameters)
            return single_device_test(
                detector, state.teacher_params if semi else None, val_ds,
                test_cfg=test_cfg, canvas_hw=canvas,
                img_scale=tp["img_scale"], img_norm=tp["img_norm"],
                device=device, group=group)

    runner = SemiRunner(
        train_step, state, data_loader, work_dir, max_epochs=max_epochs,
        log_interval=dict(cfg.get("log_config", {}) or {}).get("interval", 10),
        refresher=refresher, adathres_file=adathres_file,
        eval_fn=eval_fn, eval_interval=evaluation.get("interval", 1),
        checkpoint_interval=dict(
            cfg.get("checkpoint_config", {}) or {}).get("interval", 1),
        ema_step_decay=list(ema_cfg.get("step_decay") or []),
        ema_decay_ratio=ema_cfg.get("decay_ratio", 0.1), logger=logger,
        group=group)
    if resume_from:
        runner.resume(resume_from)
    with deterministic_cudnn():
        runner.run()
    return runner
