"""Seeded samplers with aspect-ratio grouping.

Counterpart of ``dsl_tpu/data/samplers.py``. Images are grouped by their
aspect-ratio flag (w/h > 1) so a batch has one orientation; the epoch's
order comes from ``np.random.RandomState(seed + epoch)``, drawn in the JAX
package's order, so both give the same indices. ``set_epoch`` returns the
epoch's iterator: the pseudo-label refresh reads the order ahead of the
loader. :class:`DistributedGroupSampler` gives each rank its own batches
of the epoch's order, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np


class GroupSampler:
    """Single-process group sampler."""

    def __init__(self, dataset, samples_per_gpu: int = 1, seed: int = 0):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.seed = seed
        self.epoch = 0
        self.flag = np.asarray(dataset.flag, np.int64)
        self.group_sizes = np.bincount(self.flag)
        self.num_samples = sum(
            int(np.ceil(size / samples_per_gpu)) * samples_per_gpu
            for size in self.group_sizes)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        return iter(self)

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        indices = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == i)[0]
            rng.shuffle(idx)
            num_extra = int(np.ceil(size / self.samples_per_gpu)
                            ) * self.samples_per_gpu - len(idx)
            indices.append(np.concatenate([idx, idx[:num_extra]]))
        batches = np.concatenate(indices).reshape(-1, self.samples_per_gpu)
        perm = rng.permutation(len(batches))
        return iter(batches[perm].reshape(-1).tolist())

    def __len__(self):
        return self.num_samples


class DistributedGroupSampler:
    """Rank-sharded group sampler: the JAX package's, draw for draw. Each
    group is shuffled and tiled up to a multiple of ``samples_per_gpu *
    num_replicas``, whole batches are shuffled across groups with
    ``RandomState(seed + epoch)`` (alike on every rank), and rank ``r``
    takes batches ``r, r + R, r + 2R, ...``."""

    def __init__(self, dataset, samples_per_gpu: int = 1, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.flag = np.asarray(dataset.flag, np.int64)
        self.group_sizes = np.bincount(self.flag)
        self.num_samples = sum(
            int(np.ceil(size / samples_per_gpu / num_replicas)) * samples_per_gpu
            for size in self.group_sizes)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        return iter(self)

    def _epoch_indices(self) -> list[int]:
        rng = np.random.RandomState(self.seed + self.epoch)
        indices: list[int] = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == i)[0]
            rng.shuffle(idx)
            target = int(np.ceil(size / self.samples_per_gpu / self.num_replicas)
                         ) * self.samples_per_gpu * self.num_replicas
            idx = np.tile(idx, int(np.ceil(target / len(idx))))[:target]
            indices.extend(idx.tolist())
        batches = np.asarray(indices).reshape(-1, self.samples_per_gpu)
        perm = rng.permutation(len(batches))
        return batches[perm].reshape(-1).tolist()

    def __iter__(self):
        batches = np.asarray(self._epoch_indices()).reshape(-1, self.samples_per_gpu)
        return iter(batches[self.rank::self.num_replicas].reshape(-1).tolist())

    def __len__(self):
        return self.num_samples
