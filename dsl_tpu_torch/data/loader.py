"""Data loaders: the one-source loader and the labeled + unlabeled
``MultiDataLoader``.

Counterpart of ``dsl_tpu/data/loader.py``. A sample is decoded and
transformed on the dataset's device, in the loader's iterator, on the
current stream (the JAX package runs its cv2 pipeline in host threads);
samples land on a fixed canvas and a merged batch carries per-image
``source_weight``. ``MultiDataLoader`` takes ``ratio`` labeled:unlabeled
samples per batch, restarts each source when it runs out (bumping that
loader's epoch), and is as long as the longer source.

Data parallelism: the JAX package builds one global batch and shards its
leading axis over the mesh. Here ``rank`` ``r`` of ``n_shards`` loads
shard ``r`` of the same global batch, and only that shard: the sample
indices are drawn in the global order alike on every rank, and each rank
runs the pipeline on its own share. The global batch's canvas
(``select_canvas`` over every shard's images) is agreed by a vote on the
host group (``parallel.dist.all_gather_objects`` of the image shapes).
With ``rank=None`` the loader yields the whole global batch (one process).
"""

from __future__ import annotations

from dsl_tpu_torch.data.formatting import (
    DEFAULT_CANVAS, DEFAULT_MAX_GT, DEFAULT_MAX_IGNORE, build_batch,
    format_sample, select_canvas)
from dsl_tpu_torch.data.samplers import DistributedGroupSampler, GroupSampler
from dsl_tpu_torch.parallel.dist import all_gather_objects, host_group
from dsl_tpu_torch.parallel.mesh import local_batch_size, rank_slice


def _canvas(shapes: list, base_hw, rank) -> tuple[int, int]:
    """The global batch's canvas: over ``shapes`` alone in one process,
    over every rank's shapes under a rank."""
    if rank is not None:
        if host_group() is None:
            raise RuntimeError("a loader of one rank's shard needs the "
                               "process group (parallel.dist.init_dist)")
        shapes = [s for part in all_gather_objects(shapes) for s in part]
    return select_canvas(shapes, base_hw)


class DetDataLoader:
    """Map-style loader: sampler -> pipeline -> fixed-shape batches, one
    epoch per ``__iter__``. With ``rank`` set, each batch of
    ``samples_per_gpu`` is a global batch split over ``n_shards`` ranks (the
    JAX package's supervised batch on its mesh; it must split evenly) and
    the loader yields this rank's rows of it."""

    def __init__(self, dataset, samples_per_gpu: int = 2, sampler=None,
                 canvas_hw=DEFAULT_CANVAS, max_gt: int = DEFAULT_MAX_GT,
                 max_ignore: int = DEFAULT_MAX_IGNORE, seed: int = 0,
                 source_weight: float = 1.0, n_shards: int = 1,
                 rank: int | None = None):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.sampler = sampler or GroupSampler(dataset, samples_per_gpu,
                                               seed=seed)
        self.canvas_hw = tuple(canvas_hw)
        self.max_gt = max_gt
        self.max_ignore = max_ignore
        self.source_weight = source_weight
        self.n_shards = n_shards
        self.rank = rank
        if rank is not None:
            local_batch_size(samples_per_gpu, n_shards)
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

    def __iter__(self):
        indices = self.upcoming_indices()
        spg = self.samples_per_gpu
        for start in range(0, len(indices) - spg + 1, spg):
            batch = indices[start:start + spg]
            if self.rank is not None:
                batch = rank_slice(batch, self.rank, self.n_shards)
            raw = [self.dataset[i] for i in batch]
            canvas = _canvas([r["img"].shape[:2] for r in raw], self.canvas_hw,
                             self.rank)
            yield build_batch([self.format(r, canvas) for r in raw],
                              source_weights=[self.source_weight] * len(raw))


class _Endless:
    """A loader's epoch order, restarted with the next epoch whenever it
    runs out."""

    def __init__(self, loader: DetDataLoader):
        self.loader = loader
        self._it = None

    def take(self, n: int) -> list[int]:
        out = []
        while len(out) < n:
            if self._it is None:
                self._it = iter(self.loader.upcoming_indices())
            try:
                out.append(next(self._it))
            except StopIteration:
                self.loader.epoch += 1
                self._it = iter(self.loader.upcoming_indices())
        return out


class MultiDataLoader:
    """Merged batches: per shard ``samples_per_gpu`` labeled samples and
    ``round(samples_per_gpu * ratio[1] / ratio[0])`` unlabeled ones
    (weights 1.0 and ``unlabel_weight``), then, with ``scale_invariant``,
    the half-res copy of the shard's last unlabeled one. A global batch is
    ``n_shards`` such shards drawn one after another from the two endless
    streams, and an epoch ``max(len) // n_shards`` of them, as in the JAX
    package; ``rank`` ``r`` loads and yields shard ``r`` (``None``: all of
    them). The runner reads ``label_loader``, ``unlabel_loader`` and
    ``ratio``."""

    def __init__(self, label_loader: DetDataLoader,
                 unlabel_loader: DetDataLoader, ratio=(1, 1),
                 unlabel_weight: float = 1.0, scale_invariant: bool = False,
                 n_shards: int = 1, rank: int | None = None):
        self.label_loader = label_loader
        self.unlabel_loader = unlabel_loader
        self.ratio = tuple(ratio)
        self.unlabel_weight = unlabel_weight
        self.scale_invariant = scale_invariant
        self.n_shards = n_shards
        self.rank = rank

    def __len__(self):
        return max(1, max(len(self.label_loader), len(self.unlabel_loader))
                   // self.n_shards)

    def set_epoch(self, epoch: int):
        return [self.label_loader.set_epoch(epoch),
                self.unlabel_loader.set_epoch(epoch)]

    def draws(self):
        """Per iteration, the global draw: for each shard, its labeled and
        unlabeled dataset indices."""
        n_lab = self.label_loader.samples_per_gpu
        n_unl = max(1, int(round(n_lab * self.ratio[1] / self.ratio[0])))
        lab = _Endless(self.label_loader)
        unl = _Endless(self.unlabel_loader)
        for _ in range(len(self)):
            yield [(lab.take(n_lab), unl.take(n_unl))
                   for _ in range(self.n_shards)]

    def __iter__(self):
        lab_ds = self.label_loader.dataset
        unl_ds = self.unlabel_loader.dataset
        for draw in self.draws():
            shards = draw if self.rank is None else [draw[self.rank]]
            raw, weights = [], []
            for lab, unl in shards:
                raw += [lab_ds[i] for i in lab] + [unl_ds[i] for i in unl]
                weights += [1.0] * len(lab) + [self.unlabel_weight] * len(unl)
            canvas = _canvas([r["img"].shape[:2] for r in raw],
                             self.label_loader.canvas_hw, self.rank)
            yield build_batch([self.label_loader.format(r, canvas) for r in raw],
                              source_weights=weights,
                              scale_invariant=self.scale_invariant,
                              n_shards=len(shards))


def build_dataloader(dataset, samples_per_gpu: int = 2, num_replicas: int = 1,
                     rank: int = 0, seed: int = 0, dist: bool = False,
                     canvas_hw=DEFAULT_CANVAS, **kwargs) -> DetDataLoader:
    """The loader a config asks for: with ``dist`` and more than one replica,
    each rank's own batches of ``samples_per_gpu`` from
    :class:`DistributedGroupSampler` (the reference's DDP loader), else the
    one-process loader."""
    if dist and num_replicas > 1:
        sampler = DistributedGroupSampler(dataset, samples_per_gpu,
                                          num_replicas, rank, seed)
    else:
        sampler = GroupSampler(dataset, samples_per_gpu, seed)
    return DetDataLoader(dataset, samples_per_gpu, sampler=sampler,
                         canvas_hw=canvas_hw, seed=seed, **kwargs)
