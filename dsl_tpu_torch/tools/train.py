"""Training CLI of the port, argument for argument ``tools/train.py``.

    python -m dsl_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--resume-from CKPT] [--seed N] [--cfg-options k=v ...]
        [--device cuda]

One process on one card (``--device cpu`` runs on the CPU). ``--launcher``
and ``--max-devices`` take only their single-process values (``none``, 1):
distributed training is not ported yet and they raise otherwise. The
resolved config is dumped into the work dir, then ``train_detector`` runs
it: DSL's supervised baseline for a config without ``data.unlabel_train``,
the semi-supervised loop for one with it.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from dsl_tpu_torch.config import Config
from dsl_tpu_torch.config.config import DictAction


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", help="checkpoint to resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-devices", type=int, default=None,
                   help="cards to train on: one")
    p.add_argument("--cfg-options", nargs="+", action=DictAction,
                   help="override config: key=value with dots for nesting")
    p.add_argument("--launcher", default="none",
                   help="multi-process launcher: none")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def check_single_process(args):
    """Refuse a launcher or a device count other than one process on one
    card."""
    if args.launcher != "none":
        raise NotImplementedError(f"--launcher {args.launcher}: distributed "
                                  f"runs are not ported yet")
    if getattr(args, "max_devices", None) not in (None, 1):
        raise NotImplementedError(f"--max-devices {args.max_devices}: one "
                                  f"card per process")


def main(argv=None):
    """Run the CLI; returns the runner after its last epoch."""
    args = parse_args(argv)
    check_single_process(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    work_dir = args.work_dir or osp.join(
        "./work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(osp.join(work_dir, osp.basename(args.config)))

    from dsl_tpu_torch.apis.train import train_detector

    return train_detector(cfg, work_dir, resume_from=args.resume_from,
                          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
