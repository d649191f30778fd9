"""Data loaders: the one-source loader and the labeled + unlabeled
``MultiDataLoader``.

Counterpart of ``dsl_tpu/data/loader.py``. A sample is decoded and
transformed on the dataset's device, in the loader's iterator, on the
current stream (the JAX package runs its cv2 pipeline in host threads);
samples land on a fixed canvas and a merged batch carries per-image
``source_weight``. ``MultiDataLoader`` takes ``ratio`` labeled:unlabeled
samples per batch, restarts each source when it runs out (bumping that
loader's epoch), and is as long as the longer source.
"""

from __future__ import annotations

from typing import Iterator

from dsl_tpu_torch.data.formatting import (
    DEFAULT_CANVAS, DEFAULT_MAX_GT, DEFAULT_MAX_IGNORE, build_batch,
    format_sample, select_canvas)
from dsl_tpu_torch.data.samplers import GroupSampler


class DetDataLoader:
    """Map-style loader: sampler -> pipeline -> fixed-shape batches, one
    epoch per ``__iter__``."""

    def __init__(self, dataset, samples_per_gpu: int = 2, sampler=None,
                 canvas_hw=DEFAULT_CANVAS, max_gt: int = DEFAULT_MAX_GT,
                 max_ignore: int = DEFAULT_MAX_IGNORE, seed: int = 0,
                 source_weight: float = 1.0):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.sampler = sampler or GroupSampler(dataset, samples_per_gpu,
                                               seed=seed)
        self.canvas_hw = tuple(canvas_hw)
        self.max_gt = max_gt
        self.max_ignore = max_ignore
        self.source_weight = source_weight
        self.epoch = 0

    def __len__(self):
        return len(self.sampler) // self.samples_per_gpu

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        return self.sampler.set_epoch(epoch)

    def upcoming_indices(self) -> list[int]:
        """Dataset indices of this epoch in the order they are consumed."""
        return list(self.sampler.set_epoch(self.epoch))

    def format(self, results: dict, canvas_hw) -> dict:
        return format_sample(results, canvas_hw, self.max_gt, self.max_ignore)

    def sample_iter(self) -> Iterator[dict]:
        for i in self.upcoming_indices():
            yield self.dataset[i]

    def __iter__(self):
        batch = []
        for sample in self.sample_iter():
            batch.append(sample)
            if len(batch) == self.samples_per_gpu:
                canvas = select_canvas(
                    [r["img"].shape[:2] for r in batch], self.canvas_hw)
                yield build_batch(
                    [self.format(r, canvas) for r in batch],
                    source_weights=[self.source_weight] * len(batch))
                batch = []


class _Endless:
    """A loader's sample stream, restarted with the next epoch whenever it
    runs out."""

    def __init__(self, loader: DetDataLoader):
        self.loader = loader
        self._it = iter(loader.sample_iter())

    def take(self, n: int) -> list[dict]:
        out = []
        while len(out) < n:
            try:
                out.append(next(self._it))
            except StopIteration:
                self.loader.epoch += 1
                self._it = iter(self.loader.sample_iter())
        return out


class MultiDataLoader:
    """Merged batches of ``samples_per_gpu`` labeled samples and
    ``round(samples_per_gpu * ratio[1] / ratio[0])`` unlabeled ones
    (weights 1.0 and ``unlabel_weight``), then, with ``scale_invariant``,
    the half-res copy of the last unlabeled one. The runner reads
    ``label_loader``, ``unlabel_loader`` and ``ratio``."""

    def __init__(self, label_loader: DetDataLoader,
                 unlabel_loader: DetDataLoader, ratio=(1, 1),
                 unlabel_weight: float = 1.0, scale_invariant: bool = False):
        self.label_loader = label_loader
        self.unlabel_loader = unlabel_loader
        self.ratio = tuple(ratio)
        self.unlabel_weight = unlabel_weight
        self.scale_invariant = scale_invariant

    def __len__(self):
        return max(1, len(self.label_loader), len(self.unlabel_loader))

    def set_epoch(self, epoch: int):
        return [self.label_loader.set_epoch(epoch),
                self.unlabel_loader.set_epoch(epoch)]

    def __iter__(self):
        n_lab = self.label_loader.samples_per_gpu
        n_unl = max(1, int(round(n_lab * self.ratio[1] / self.ratio[0])))
        lab = _Endless(self.label_loader)
        unl = _Endless(self.unlabel_loader)
        for _ in range(len(self)):
            raw = lab.take(n_lab) + unl.take(n_unl)
            weights = [1.0] * n_lab + [self.unlabel_weight] * n_unl
            canvas = select_canvas([r["img"].shape[:2] for r in raw],
                                   self.label_loader.canvas_hw)
            yield build_batch([self.label_loader.format(r, canvas) for r in raw],
                              source_weights=weights,
                              scale_invariant=self.scale_invariant)
