"""Evaluation and inference CLI of the port, argument for argument
``tools/test.py``.

    python -m dsl_tpu_torch.tools.test CONFIG [CHECKPOINT] [--eval bbox [segm]]
        [--out results.json] [--format-only] [--ema]
        [--cfg-options k=v ...] [--device cuda]

Predicts every image of ``data.test`` (else ``data.val``) with the
checkpoint's weights (``utils/checkpoint.load_weights``: a weights file, a
``train_detector`` checkpoint's student, or its EMA teacher with ``--ema``,
or an mmdet-layout ``.pth``; without a checkpoint, the random init from
seed 0), then prints the dataset's metrics: COCO bbox mAP for a
``CocoDataset`` or ``Voc2CocoDataset``, VOC mAP for a ``VOCDataset``. As in
the JAX CLI, box results are evaluated with ``metric="bbox"`` whatever
``--eval`` names (``mAP`` or ``bbox``): the dataset decides the protocol;
a Mask R-CNN's results (with masks) with the metrics ``--eval`` names
(``bbox segm``). ``segm`` for a detector that gives no masks raises (the
JAX CLI evaluates its boxes alone), and ``proposal`` (an RPN's recall) is
not ported and raises. ``--out``
or ``--format-only`` writes the COCO-format detections
(``<checkpoint>.bbox.json`` unless ``--out`` names the file, and with
``--eval segm`` the masks' ``.segm.json`` beside it);
``--format-only`` computes no metric. That json is what
``tools/generate_unlabel_annos_coco.py`` (or ``_voc.py``, from a
``SemiVOCDataset``'s list ids) turns into DSL's first pseudo-labels.
Without a launcher, one process on one card; under ``--launcher pytorch``
(``dsl_tpu_torch/tools/dist_test.sh``) or ``slurm`` each rank predicts its
share of the batches, and rank 0 writes the json and prints the metrics,
which are the single process's.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import random

import numpy as np

from dsl_tpu_torch.config import Config
from dsl_tpu_torch.config.config import DictAction
from dsl_tpu_torch.parallel import dist
from dsl_tpu_torch.tools.train import LAUNCHERS, start_processes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--eval", nargs="+", default=["bbox"])
    p.add_argument("--out", help="write the detections json here")
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA (teacher) weights")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", choices=LAUNCHERS, default="none",
                   help="multi-process launcher (as tools/train.py's)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns (per-image results, metrics or None)."""
    args = parse_args(argv)
    unported = [m for m in args.eval if m not in ("bbox", "mAP", "segm")]
    if unported:
        raise NotImplementedError(f"--eval {' '.join(unported)}: only bbox, "
                                  f"mAP and segm are ported (proposals are "
                                  f"not)")
    device = start_processes(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    from dsl_tpu_torch.apis.test import MASK_RESULTS

    if "segm" in args.eval and cfg.model.get("type") not in MASK_RESULTS:
        raise NotImplementedError(f"--eval segm: {cfg.model.get('type')} "
                                  f"gives no masks")

    from dsl_tpu_torch.apis.inference import load_detector
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.apis.train import build_dataset
    from dsl_tpu_torch.data.formatting import DEFAULT_CANVAS
    from dsl_tpu_torch.data.pipelines import test_pipeline_params
    from dsl_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    canvas = tuple(cfg.get("canvas_hw") or DEFAULT_CANVAS)
    detector = load_detector(cfg.model, args.checkpoint, ema=args.ema)
    detector.to(device).eval()

    data_cfg = dict(cfg.data.get("test", cfg.data.get("val")))
    ds = build_dataset({**data_cfg, "test_mode": True}, device,
                       np.random.RandomState(0), random.Random(0))
    tp = test_pipeline_params(data_cfg.get("pipeline"))
    results = single_device_test(
        detector, None, ds, test_cfg=dict(cfg.model.get("test_cfg", {}) or {}),
        canvas_hw=canvas, img_scale=tp["img_scale"], img_norm=tp["img_norm"],
        evaluate=False, device=device, group=dist.group())
    main_rank = dist.is_main_process()
    if args.launcher != "none":
        dist.destroy()
    if not main_rank:
        return results, None

    masks = len(results[0]) > 2
    if args.out or args.format_only:
        dt = ds.results2json_bbox([r[:2] for r in results])
        out = args.out or (osp.splitext(args.checkpoint or "results")[0]
                           + ".bbox.json")
        with open(out, "w") as f:
            json.dump(dt, f)
        print(f"wrote {len(dt)} detections to {out}")
        if "segm" in args.eval and masks:
            sout = out.replace(".bbox.json", ".segm.json")
            with open(sout, "w") as f:
                json.dump(ds.results2json_segm(results), f)
            print(f"wrote segm results to {sout}")
    metrics = None
    if not args.format_only:
        metrics = ds.evaluate(results, metric=args.eval if masks else "bbox")
        print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return results, metrics


if __name__ == "__main__":
    main()
