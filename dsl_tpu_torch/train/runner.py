"""SemiRunner: the epoch loop of semi-supervised training.

Counterpart of ``dsl_tpu/train/runner.py``. Each iteration: the train step
(loss, backward, SGD, EMA; it updates the state in place), then the
pseudo-label refresher's ``complete()`` of the refresh dispatched last
iteration, then this iteration's dispatch, so the teacher's predict
overlaps the next step. The look-ahead order covers this epoch's unlabeled
order and the next's. Each epoch: a checkpoint, the refresher's epoch work
(adathres), and the EMA ratio's step decay at the configured epochs.
Metrics stay tensors until a log line needs them, so no iteration waits on
the card for its logging. ``train.log`` and ``train.log.json`` are written
as the JAX package writes them.

Under data parallelism (``group``) every rank runs the loop on its shard
with the same schedule; rank 0 alone writes the logs and checkpoints. A
barrier follows each refresh's ``complete()`` (a rank's next batch may read
a label file another rank just wrote, and reads it where the single
process would), each epoch's end, and an evaluation's start and end.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Callable

import numpy as np
import torch

from dsl_tpu_torch.parallel.dist import barrier
from dsl_tpu_torch.train.train_state import TrainState
from dsl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dsl_tpu_torch.utils.logger import get_root_logger


class LogBuffer:
    """Running averages of scalar metrics (mmcv's LogBuffer). Values may be
    0-d tensors until :meth:`to_host` (called by :meth:`average` and at
    the end of each epoch) reads them on the host and keeps floats in their
    place, so the history holds no device memory past a log line or an
    epoch."""

    def __init__(self):
        self.history: dict[str, list] = {}

    def update(self, vals: dict):
        for k, v in vals.items():
            if torch.is_tensor(v) and v.numel() != 1:
                continue
            self.history.setdefault(k, []).append(v)

    def to_host(self):
        """Replace the tensors appended since the last call by floats."""
        for v in self.history.values():
            i = len(v)
            while i and torch.is_tensor(v[i - 1]):
                i -= 1
            v[i:] = [float(x) for x in v[i:]]

    def average(self, window: int = 50) -> dict:
        self.to_host()
        return {k: float(np.mean(v[-window:])) for k, v in self.history.items()}


class SemiRunner:
    def __init__(self, train_step: Callable, state: TrainState,
                 data_loader, work_dir: str, max_epochs: int = 28,
                 log_interval: int = 10, refresher=None,
                 adathres_file: str | None = None,
                 adathres_settings: dict | None = None,
                 eval_fn: Callable | None = None, eval_interval: int = 1,
                 checkpoint_interval: int = 1,
                 ema_step_decay: list[int] | None = None,
                 ema_decay_ratio: float = 0.1, logger=None, group=None):
        self.train_step = train_step
        self.state = state
        self.data_loader = data_loader
        self.work_dir = work_dir
        self.max_epochs = max_epochs
        self.log_interval = log_interval
        self.refresher = refresher
        self.adathres_file = adathres_file
        self.adathres_settings = adathres_settings
        self.eval_fn = eval_fn
        self.eval_interval = eval_interval
        self.checkpoint_interval = checkpoint_interval
        self.ema_step_decay = ema_step_decay or []
        self.ema_decay_ratio = ema_decay_ratio
        self.epoch = 0
        self.main = group is None or torch.distributed.get_rank(group) == 0
        self.log_buffer = LogBuffer()
        os.makedirs(work_dir, exist_ok=True)
        self.logger = logger or get_root_logger(
            log_file=osp.join(work_dir, "train.log"))
        self.json_log_path = osp.join(work_dir, "train.log.json")

    def run(self):
        self.logger.info("Start training: %d epochs, %d iters/epoch",
                         self.max_epochs, len(self.data_loader))
        while self.epoch < self.max_epochs:
            self.train_epoch()
            if (self.epoch + 1) % self.checkpoint_interval == 0:
                self.save_checkpoint()
            if self.refresher is not None:
                self.refresher.after_train_epoch(
                    self.state, self.epoch, self.adathres_file,
                    self.adathres_settings)
            if self.eval_fn and (self.epoch + 1) % self.eval_interval == 0:
                self.evaluate()
            barrier()
            self.epoch += 1
        self.logger.info("Training done.")

    def _upcoming(self):
        """Unlabeled file names in consumption order over this epoch and
        the next (the endless unlabeled stream wraps into the next epoch),
        and the unlabeled images one iteration consumes."""
        unl = self.data_loader.unlabel_loader
        order = unl.upcoming_indices()
        order = order + list(unl.sampler.set_epoch(self.epoch + 1))
        unl.sampler.set_epoch(self.epoch)
        infos = unl.dataset.data_infos
        n_lab = self.data_loader.label_loader.samples_per_gpu
        ratio = self.data_loader.ratio
        consumed = max(1, int(round(n_lab * ratio[1] / ratio[0])))
        return [infos[i]["filename"] for i in order], consumed

    def train_epoch(self):
        self.data_loader.set_epoch(self.epoch)
        upcoming, consumed = None, 0
        if self.refresher is not None and hasattr(self.data_loader,
                                                  "unlabel_loader"):
            upcoming, consumed = self._upcoming()
        t_data = time.perf_counter()
        pending_refresh = None
        for it, batch in enumerate(self.data_loader):
            data_time = time.perf_counter() - t_data
            batch.pop("meta", None)
            metrics = self.train_step(self.state, batch)
            if upcoming is not None:
                if pending_refresh is not None:
                    pending_refresh()
                    barrier()
                pending_refresh = self.refresher.dispatch_after_train_iter(
                    self.state, self.epoch, upcoming, it, consumed)
            self.log_buffer.update({
                **metrics, "time": time.perf_counter() - t_data,
                "data_time": data_time})
            if (it + 1) % self.log_interval == 0:
                self._log(it)
            t_data = time.perf_counter()
        if pending_refresh is not None:
            pending_refresh()
            barrier()
        self.log_buffer.to_host()
        if (self.epoch + 1) in self.ema_step_decay:
            # EMAOWNHook.step_decay: ratio -> max(1 - (1 - r) / decay, 0.01)
            r = float(self.state.ema_ratio)
            new_r = max(1.0 - (1.0 - r) / self.ema_decay_ratio, 0.01)
            self.state.ema_ratio = torch.tensor(
                new_r, dtype=torch.float32, device=self.state.ema_ratio.device)
            self.logger.info("EMA ratio step-decay at epoch %d: %f -> %f",
                             self.epoch + 1, r, new_r)

    def _log(self, it: int):
        avg = self.log_buffer.average(self.log_interval)
        if not self.main:
            return
        msg = " ".join(f"{k}: {v:.4f}" for k, v in avg.items())
        self.logger.info("Epoch [%d][%d/%d] %s", self.epoch + 1, it + 1,
                         len(self.data_loader), msg)
        with open(self.json_log_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(dict(mode="train", epoch=self.epoch + 1,
                                    iter=it + 1, **{
                                        k: round(v, 5) for k, v in avg.items()}))
                    + "\n")

    def evaluate(self) -> dict | None:
        """The eval function's metrics, logged (rank 0; None elsewhere)."""
        barrier()
        metrics = self.eval_fn(self.state)
        barrier()
        if not self.main:
            return None
        self.logger.info("eval epoch %d: %s", self.epoch + 1, metrics)
        with open(self.json_log_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(dict(mode="val", epoch=self.epoch + 1,
                                    **metrics)) + "\n")
        return metrics

    def save_checkpoint(self, name: str | None = None):
        """``epoch_N.pth`` in the work dir and a ``latest`` link to it
        (rank 0)."""
        if not self.main:
            return
        name = name or f"epoch_{self.epoch + 1}.pth"
        path = osp.join(self.work_dir, name)
        save_checkpoint(path, self.state, meta=dict(epoch=self.epoch + 1))
        latest = osp.join(self.work_dir, "latest")
        if osp.lexists(latest):
            os.remove(latest)
        os.symlink(name, latest)
        self.logger.info("Saved checkpoint %s", path)

    def resume(self, path: str):
        self.state, meta = load_checkpoint(path, self.state)
        self.epoch = int(meta.get("epoch", 0))
        self.logger.info("Resumed from %s at epoch %d", path, self.epoch)
