"""Dataset wrappers: ``ConcatDataset``, ``RepeatDataset``,
``ClassBalancedDataset``.

Counterpart of ``dsl_tpu/data/datasets/wrappers.py``: the same lengths,
index maps, group flags (for ``GroupSampler`` and
``DistributedGroupSampler``), ``CLASSES`` and repeat factors (LVIS
repeat-factor sampling: an image repeats ``ceil(max over its categories of
max(1, sqrt(oversample_thr / frequency)))`` times). A wrapped dataset given
as a config dict is built with the wrapper's ``device``, ``rng`` and
``pyrng`` (what ``apis/train.build_dataset`` passes every dataset), as
mmdet's ``build_dataset`` builds it. ``evaluate`` goes to the wrapped
dataset; a ``ConcatDataset`` evaluates each part on its own slice of the
results, keys prefixed with the part's index (mmdet's ``separate_eval``).
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict

import numpy as np

from dsl_tpu_torch.registry import DATASETS, build_from_cfg


def _built(dataset, device, rng, pyrng):
    if isinstance(dataset, dict):
        return build_from_cfg({**dataset, "device": device, "rng": rng,
                               "pyrng": pyrng}, DATASETS)
    return dataset


@DATASETS.register
class ConcatDataset:
    def __init__(self, datasets, device="cuda", rng=None, pyrng=None):
        self.datasets = [_built(d, device, rng, pyrng) for d in datasets]
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()
        self.CLASSES = getattr(self.datasets[0], "CLASSES", ())
        if all(hasattr(d, "flag") for d in self.datasets):
            self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        base = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return ds_idx, idx - base

    def __getitem__(self, idx):
        ds_idx, sample_idx = self._locate(idx)
        return self.datasets[ds_idx][sample_idx]

    def get_ann_info(self, idx):
        ds_idx, sample_idx = self._locate(idx)
        return self.datasets[ds_idx].get_ann_info(sample_idx)

    def evaluate(self, results, **kwargs):
        if len(results) != len(self):
            raise ValueError(f"{len(results)} results for {len(self)} images")
        out, start = {}, 0
        for i, (ds, end) in enumerate(zip(self.datasets, self.cumulative_sizes)):
            for k, v in ds.evaluate(results[start:end], **kwargs).items():
                out[f"{i}_{k}"] = v
            start = end
        return out


@DATASETS.register
class RepeatDataset:
    def __init__(self, dataset, times, device="cuda", rng=None, pyrng=None):
        self.dataset = _built(dataset, device, rng, pyrng)
        self.times = times
        self.CLASSES = getattr(self.dataset, "CLASSES", ())
        if hasattr(self.dataset, "flag"):
            self.flag = np.tile(self.dataset.flag, times)
        self._len = times * len(self.dataset)

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(idx % len(self.dataset))

    def evaluate(self, results, **kwargs):
        return self.dataset.evaluate(results, **kwargs)


@DATASETS.register
class ClassBalancedDataset:
    """Oversample images holding rare classes (module docstring)."""

    def __init__(self, dataset, oversample_thr: float, device="cuda",
                 rng=None, pyrng=None):
        self.dataset = _built(dataset, device, rng, pyrng)
        self.oversample_thr = oversample_thr
        self.CLASSES = getattr(self.dataset, "CLASSES", ())
        self.repeat_factors = self._repeat_factors(self.dataset,
                                                   oversample_thr)
        self.indices = [i for i, rf in enumerate(self.repeat_factors)
                        for _ in range(int(math.ceil(rf)))]
        if hasattr(self.dataset, "flag"):
            self.flag = np.asarray([self.dataset.flag[i] for i in self.indices],
                                   np.uint8)

    @staticmethod
    def _repeat_factors(dataset, thr):
        cat_freq = defaultdict(float)
        n = len(dataset)
        img_cats = []
        for i in range(n):
            cats = {int(c) for c in dataset.get_ann_info(i)["labels"]}
            img_cats.append(cats)
            for c in cats:
                cat_freq[c] += 1.0 / n
        cat_repeat = {c: max(1.0, math.sqrt(thr / f))
                      for c, f in cat_freq.items()}
        return [max([cat_repeat[c] for c in cats], default=1.0)
                for cats in img_cats]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(self.indices[idx])

    def evaluate(self, results, **kwargs):
        return self.dataset.evaluate(results, **kwargs)
