"""Training CLI of the port, argument for argument ``tools/train.py``.

    python -m dsl_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--resume-from CKPT] [--seed N] [--cfg-options k=v ...]
        [--launcher none|pytorch|slurm] [--device cuda]

Without a launcher, one process on one card (``--device cpu`` runs on the
CPU). Data-parallel training runs one process per card under a launcher,
the counterpart of the JAX CLI's ``--launcher jax|slurm``:

    python -m torch.distributed.run --nproc_per_node=8 \
        -m dsl_tpu_torch.tools.train CONFIG --launcher pytorch

(``dsl_tpu_torch/tools/dist_train.sh``), or ``--launcher slurm`` under
``srun``; each rank joins the process group (``parallel.dist.init_dist``:
NCCL on the cards, gloo with ``--device cpu``) and trains on
``cuda:LOCAL_RANK``. ``--max-devices`` above 1 without a launcher raises:
the launcher starts the processes. The resolved config is dumped into the
work dir (by rank 0), then ``train_detector`` runs it: DSL's supervised
baseline for a config without ``data.unlabel_train``, the semi-supervised
loop for one with it.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from dsl_tpu_torch.config import Config
from dsl_tpu_torch.config.config import DictAction
from dsl_tpu_torch.parallel import dist

LAUNCHERS = ("none", "pytorch", "slurm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", help="checkpoint to resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-devices", type=int, default=None,
                   help="cards to train on: one without a launcher, the "
                        "launcher's process count with one")
    p.add_argument("--cfg-options", nargs="+", action=DictAction,
                   help="override config: key=value with dots for nesting")
    p.add_argument("--launcher", choices=LAUNCHERS, default="none",
                   help="multi-process launcher (pytorch: torch.distributed."
                        "run's environment; slurm: srun's)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def start_processes(args) -> str:
    """Join the launcher's process group where there is one; returns the
    device this rank runs on. ``--max-devices`` above 1 needs a launcher,
    and with one it must be the launcher's process count."""
    if args.launcher == "none":
        if getattr(args, "max_devices", None) not in (None, 1):
            raise ValueError(
                f"--max-devices {args.max_devices}: one process drives one "
                f"card; start one process per card with python -m "
                f"torch.distributed.run --nproc_per_node={args.max_devices} "
                f"... --launcher pytorch")
        return args.device
    device = str(dist.init_dist(args.launcher, args.device))
    if getattr(args, "max_devices", None) not in (None, dist.get_world_size()):
        raise ValueError(f"--max-devices {args.max_devices}: the launcher "
                         f"started {dist.get_world_size()} processes")
    return device


def main(argv=None):
    """Run the CLI; returns the runner after its last epoch."""
    args = parse_args(argv)
    device = start_processes(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    work_dir = args.work_dir or osp.join(
        "./work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if dist.is_main_process():
        cfg.dump(osp.join(work_dir, osp.basename(args.config)))

    from dsl_tpu_torch.apis.train import train_detector

    runner = train_detector(cfg, work_dir, resume_from=args.resume_from,
                            seed=args.seed, device=device)
    if args.launcher != "none":
        dist.destroy()
    return runner


if __name__ == "__main__":
    main()
