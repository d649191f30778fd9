"""Inputs that hold :func:`nms_keep` against :func:`nms_keep_reference`.

``chip_smoke.py`` runs every case through the CUDA kernel and the plain
version and requires bit-identical keeps; the CPU tests run the same cases
through the JAX package's Pallas kernel (interpret mode) and its Jacobi
``_greedy_keep``. Each case is (name, boxes (B, N, 4) f32, valid (B, N)
bool, iou_threshold), numpy, made from a seed.
"""

from __future__ import annotations

import numpy as np

FLAGSHIP_THR = 0.6
SEED = 0


def random_boxes(rng: np.random.RandomState, b: int, n: int,
                 canvas=(800, 1344)) -> np.ndarray:
    """Boxes scattered over a detection canvas, sizes 4..300 px, clustered
    enough that many pairs overlap around the threshold."""
    h, w = canvas
    centers = rng.rand(b, n, 2) * np.asarray([w, h])
    # a quarter of the boxes sit near a few hot spots, as detections do
    hot = rng.rand(b, 8, 2) * np.asarray([w, h])
    pick = rng.randint(0, 8, size=(b, n))
    near = rng.rand(b, n) < 0.25
    jitter = rng.randn(b, n, 2) * 6.0
    centers = np.where(near[..., None],
                       np.take_along_axis(hot, pick[..., None], 1) + jitter,
                       centers)
    wh = np.exp(rng.uniform(np.log(4), np.log(300), (b, n, 2)))
    return np.concatenate([centers - wh / 2, centers + wh / 2],
                          -1).astype(np.float32)


def _case(name, boxes, valid=None, thr=FLAGSHIP_THR):
    boxes = np.asarray(boxes, np.float32)
    if valid is None:
        valid = np.ones(boxes.shape[:2], bool)
    return name, boxes, np.asarray(valid, bool), float(thr)


def cases(max_n: int | None = None) -> list:
    """Every case; with ``max_n``, only those with N <= max_n."""
    rng = np.random.RandomState(SEED)
    out = [_case("random_b8_n2000", random_boxes(rng, 8, 2000))]
    for n in (1, 63, 64, 65, 2001):
        out.append(_case(f"random_n{n}", random_boxes(rng, 2, n)))

    # tied scores: identical boxes next to each other — the earlier one wins
    base = random_boxes(rng, 1, 100)
    out.append(_case("duplicates", np.repeat(base, 3, axis=1)))

    # zero-area boxes: they overlap nothing and suppress nothing
    zb = random_boxes(rng, 1, 130)
    zb[0, ::3, 2] = zb[0, ::3, 0]
    zb[0, 1::3, 3] = zb[0, 1::3, 1]
    out.append(_case("zero_area", zb))

    # a long chain: box i overlaps i+1 (IoU 0.6 > 0.5) but not i+2 (IoU
    # 1/3), so greedy keeps every other box and the Jacobi fixpoint needs
    # N rounds
    n = 300
    x = np.arange(n, dtype=np.float32) * 2.5
    chain = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], -1)[None]
    out.append(_case("long_chain", chain, thr=0.5))

    # IoU exactly at the threshold is not suppressed (strict >): 0.5 and 0.5
    at = [[0, 0, 2, 1], [0, 0, 1, 1], [10, 10, 12, 12], [10, 10, 12, 11],
          [20, 20, 24, 24], [20, 20, 24, 22]]
    out.append(_case("iou_at_threshold", np.asarray(at)[None], thr=0.5))

    # valid=False rows: never kept, never suppress
    vb = random_boxes(rng, 2, 257)
    out.append(_case("invalid_rows", vb, rng.rand(2, 257) > 0.3))

    # a batch whose images have different valid counts (the tail invalid,
    # as multiclass_nms pads its candidates)
    counts = [0, 1, 100, 1000]
    valid = np.arange(1000)[None, :] < np.asarray(counts)[:, None]
    out.append(_case("ragged_valid", random_boxes(rng, 4, 1000), valid))

    if max_n is not None:
        out = [c for c in out if c[1].shape[1] <= max_n]
    return out


def tiny_boxes() -> tuple:
    """Overlapping boxes whose unions are below 1e-6: the kernel's 1e-10
    floor and ``bbox_overlaps``' 1e-6 floor give different keeps."""
    rng = np.random.RandomState(SEED)
    n = 40
    corner = rng.rand(1, n, 2).astype(np.float32) * 1e-3
    corner = np.repeat(corner[:, :n // 2], 2, axis=1)       # pairs coincide
    side = np.float32(5e-4)
    boxes = np.concatenate([corner, corner + side], -1).astype(np.float32)
    return _case("union_below_1e-6", boxes, thr=0.5)
