"""A seeded synthetic training batch in the data layer's fixed-shape layout,
for smoke runs and parity tests (no dataset ships with the repo).

:func:`semi_batch` lays the batch out as ``dsl_tpu/data/formatting.py``
builds it (numpy, images NHWC, the JAX package's layout): labeled images
(``source_weight`` 1), then unlabeled ones (``unlabeled_weight``), then the
half-resolution copy of the last image for si-soft: the whole canvas
bilinearly halved (exactly a 2x2 mean), top-left on a zero canvas, its GT
and ignore boxes x0.5, and ``si_pair = {full: [n-1], half: [n]}``. GT is
K-padded with validity masks; boxes have integer corners, so some touch
exactly. :func:`to_torch` moves it to the port's layout on a device.
"""

from __future__ import annotations

import numpy as np
import torch


def semi_batch(seed: int, canvas: tuple[int, int], n_gt: list[int],
               n_ignore: list[int], n_labeled: int,
               unlabeled_weight: float = 3.0, k: int = 100, ki: int = 60,
               side: tuple[int, int] = (16, 600),
               num_classes: int = 80) -> dict:
    """``n_gt[i]`` and ``n_ignore[i]`` valid GT and ignore boxes for real
    image i (the first ``n_labeled`` are labeled), sides drawn in ``side``
    pixels, labels in ``[0, num_classes)``."""
    rng = np.random.RandomState(seed)
    h, w = canvas
    n = len(n_gt)

    def boxes(count: int, cap: int):
        out = np.zeros((cap, 4), np.float32)
        for j in range(count):
            bw = min(rng.randint(side[0], side[1] + 1), w)
            bh = min(rng.randint(side[0], side[1] + 1), h)
            x1, y1 = rng.randint(0, w - bw + 1), rng.randint(0, h - bh + 1)
            out[j] = (x1, y1, x1 + bw, y1 + bh)
        return out, np.arange(cap) < count

    gt = [boxes(c, k) for c in n_gt]
    ig = [boxes(c, ki) for c in n_ignore]
    images = rng.randn(n + 1, h, w, 3).astype(np.float32)
    half = np.zeros((h, w, 3), np.float32)
    half[:h // 2, :w // 2] = images[n - 1, :h // 2 * 2, :w // 2 * 2].reshape(
        h // 2, 2, w // 2, 2, 3).mean((1, 3))
    images[n] = half
    labels = rng.randint(0, num_classes, (n, k)).astype(np.int32)
    weights = [1.0] * n_labeled + [unlabeled_weight] * (n - n_labeled)
    return dict(
        images=images,
        gt_bboxes=np.stack([b for b, _ in gt] + [gt[-1][0] * 0.5]),
        gt_labels=np.concatenate([labels, labels[-1:]]),
        gt_valid=np.stack([v for _, v in gt] + [gt[-1][1]]),
        ignore_bboxes=np.stack([b for b, _ in ig] + [ig[-1][0] * 0.5]),
        ignore_valid=np.stack([v for _, v in ig] + [ig[-1][1]]),
        source_weight=np.asarray(weights + weights[-1:], np.float32),
        si_pair=dict(full=np.asarray([n - 1], np.int32),
                     half=np.asarray([n], np.int32)))


def to_torch(batch: dict, device: str | torch.device) -> dict:
    """The numpy batch as tensors on ``device``: images NCHW, labels and
    si_pair indices int64 (indices on the device, so the loss reads them
    without a copy from the host)."""
    out = {}
    for key, value in batch.items():
        if key == "si_pair":
            out[key] = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                        for k, v in value.items()}
        elif key == "images":
            out[key] = torch.from_numpy(value.transpose(0, 3, 1, 2).copy()).to(device)
        elif key == "gt_labels":
            out[key] = torch.as_tensor(value, dtype=torch.int64, device=device)
        else:
            out[key] = torch.as_tensor(value, device=device)
    return out
