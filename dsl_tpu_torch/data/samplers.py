"""Seeded samplers with aspect-ratio grouping.

Counterpart of ``dsl_tpu/data/samplers.py``. Images are grouped by their
aspect-ratio flag (w/h > 1) so a batch has one orientation; the epoch's
order comes from ``np.random.RandomState(seed + epoch)``, drawn in the JAX
package's order, so both give the same indices. ``set_epoch`` returns the
epoch's iterator: the pseudo-label refresh reads the order ahead of the
loader.
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


class DistributedGroupSampler(GroupSampler):
    """The rank-sharded sampler waits for the port's data-parallel slice;
    one replica is :class:`GroupSampler`."""

    def __init__(self, dataset, samples_per_gpu: int = 1, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0):
        if num_replicas > 1:
            raise NotImplementedError(
                "DistributedGroupSampler over more than one replica is not "
                "ported yet (it comes with data-parallel training)")
        super().__init__(dataset, samples_per_gpu, seed)
