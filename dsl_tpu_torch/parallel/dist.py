"""Process groups for data-parallel training and testing, one process per
card.

Counterpart of ``dsl_tpu/parallel/dist.py``. The JAX package runs one
program over a device mesh, where XLA inserts the collectives; the port
runs one process per card under a launcher and calls them itself:

- :func:`init_dist` joins the process group a launcher describes:
  ``pytorch`` (``torch.distributed.run``: ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or ``slurm``
  (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``; the address is
  the first host of ``SLURM_NODELIST`` unless ``MASTER_ADDR`` names one).
  NCCL on the card (rank ``r`` takes ``cuda:LOCAL_RANK``), gloo on the
  CPU, or the backend the caller names; a backend that cannot serve
  raises, it is never swapped for another. :func:`init_group` joins one
  from an explicit address (the tests give ``file://`` stores).
- Tensors on the card go through the default group (NCCL there). Host
  objects (a loader's canvas vote, results gathered for evaluation, a
  barrier) go through a gloo group of the same ranks (:func:`host_group`),
  so they never wait on the card's stream.
- :func:`group` is None where there is one process (no launcher, or a
  launcher with one rank): the callers then run no collective at all, so
  one rank under a launcher is bit-identical to no launcher.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_HOST = None                  # the gloo group for host objects


def init_group(backend: str, init_method: str, rank: int, world_size: int):
    """Join a process group of ``world_size`` ranks as ``rank``; returns the
    default group. ``backend`` is ``nccl`` or ``gloo``."""
    global _HOST
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_group: NCCL needs CUDA, which is not "
                           "available; name backend='gloo' for the CPU")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _HOST = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    return dist.group.WORLD


_NEEDS = {"pytorch": ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                      "MASTER_PORT"),
          "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
                    "SLURM_NODELIST")}


def _launcher_env(launcher: str) -> tuple[int, int, int]:
    env = os.environ
    missing = [k for k in _NEEDS.get(launcher, ()) if k not in env]
    if missing:
        raise RuntimeError(
            f"--launcher {launcher}: {', '.join(missing)} not set; start the "
            f"processes with " + ("python -m torch.distributed.run"
                                  if launcher == "pytorch" else "srun"))
    if launcher == "pytorch":
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"])
    if launcher == "slurm":
        if "MASTER_ADDR" not in env:
            first = subprocess.run(
                ["scontrol", "show", "hostnames", env["SLURM_NODELIST"]],
                check=True, capture_output=True, text=True).stdout.split()[0]
            env["MASTER_ADDR"] = first
        env.setdefault("MASTER_PORT", "29500")
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env["SLURM_LOCALID"]))
    raise ValueError(f"init_dist: unknown launcher {launcher!r} (pytorch or "
                     f"slurm)")


def init_dist(launcher: str, device: str | torch.device = "cuda",
              backend: str | None = None) -> torch.device:
    """Join the process group ``launcher`` describes; returns this rank's
    device (``cuda:LOCAL_RANK``, made current, on the card)."""
    rank, world, local = _launcher_env(launcher)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_dist: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    init_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
               "env://", rank, world)
    return device


def group():
    """The default group where more than one process runs, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def host_group():
    """The gloo group of the same ranks, for host objects (None where one
    process runs)."""
    return _HOST if group() is not None else None


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    """Wait for every rank (on the host group; nothing where one process
    runs)."""
    if host_group() is not None:
        dist.barrier(group=host_group())


def all_gather_objects(obj: Any) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if host_group() is None:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def reduce_mean(value: float) -> float:
    """The mean of a host scalar over the ranks."""
    return float(np.mean(all_gather_objects(float(value))))


def destroy() -> None:
    """Leave the process group (where one was joined)."""
    global _HOST
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST = None
