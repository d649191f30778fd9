"""Inputs that hold :func:`nms_keep` against :func:`nms_keep_reference`.

``chip_smoke.py`` runs every case through the CUDA kernel and the plain
version and requires bit-identical keeps; the CPU tests run the same cases
through the JAX package's Pallas kernel (interpret mode) and its Jacobi
``_greedy_keep``. :func:`timing_cases` are too large for the CPU tests and
run only on the card. Each case is (name, boxes (B, N, 4) f32, valid
(B, N) bool, iou_threshold), numpy, made from a seed.
"""

from __future__ import annotations

import numpy as np

FLAGSHIP_THR = 0.6
SEED = 0
# thresholds of the iou_ulp cases: the flagship's, a power of two (one ulp
# below it is half an ulp above it), and one each in the binades below and
# above 0.5
ULP_THRESHOLDS = (0.6, 0.5, 0.3, 0.7)
# pairs of threshold_pairs at each of its three IoUs
PAIRS_PER_TARGET = 4


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


def iou_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of boxes a[k] and b[k] in the kernel's f32 rounding: areas from
    the coordinates, union (area_a + area_b) - inter floored at 1e-10, one
    IEEE division."""
    def area(x):
        return (np.maximum(x[:, 2] - x[:, 0], np.float32(0))
                * np.maximum(x[:, 3] - x[:, 1], np.float32(0)))

    wh = np.maximum(np.minimum(a[:, 2:], b[:, 2:]) - np.maximum(a[:, :2], b[:, :2]),
                    np.float32(0))
    inter = wh[:, 0] * wh[:, 1]
    union = np.maximum(area(a) + area(b) - inter, np.float32(1e-10))
    return inter / union


def threshold_pairs(rng: np.random.RandomState, thr: float) -> np.ndarray:
    """Pairs (a, b), b inside a, whose f32 IoU is exactly the f32 threshold
    or one ulp below or above it: PAIRS_PER_TARGET pairs each, in that
    order, (1, 6*PAIRS_PER_TARGET, 4), each pair 100 px right of the one
    before so pairs never overlap.

    Found by search: b's height is stepped by single ulps around the height
    that gives thr, and each IoU is computed from the final coordinates."""
    t = np.float32(thr)
    targets = (np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1)))
    n = 64
    x0 = np.float32(100) * np.arange(3 * PAIRS_PER_TARGET, dtype=np.float32)
    size = rng.uniform(20, 60, (n, 2)).astype(np.float32)
    w = size[:, 0] * rng.uniform(0.8, 1.0, n).astype(np.float32)
    h = (t * size[:, 0] * size[:, 1] / w).astype(np.float32)
    steps = np.arange(-30, 31, dtype=np.float32)
    h = (h[:, None] + steps * np.spacing(h)[:, None]).ravel()
    w, size = np.repeat(w, len(steps)), np.repeat(size, len(steps), axis=0)
    out = []
    for k, target in enumerate(targets):
        for p in range(PAIRS_PER_TARGET):
            left = x0[k * PAIRS_PER_TARGET + p]
            a = np.stack([np.full_like(w, left), np.zeros_like(w),
                          left + size[:, 0], size[:, 1]], -1)
            b = np.stack([a[:, 0], a[:, 1], left + w, h], -1)
            hit = np.nonzero(iou_f32(a, b) == target)[0]
            pick = hit[rng.randint(len(hit))]
            out += [a[pick], b[pick]]
    return np.stack(out)[None]


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

    # IoUs at the f32 threshold and one ulp either side: only the pairs one
    # ulp above are suppressed
    for thr in ULP_THRESHOLDS:
        out.append(_case(f"iou_ulp_thr{thr}", threshold_pairs(rng, thr), thr=thr))

    if max_n is not None:
        out = [c for c in out if c[1].shape[1] <= max_n]
    return out


def timing_cases() -> list:
    """Card-only inputs, too large for the CPU tests: the timing inputs of
    ``chip_smoke.py`` besides the recorded predict inputs, and N past the
    shared-memory ceiling of the first version of the kernel (about 28k)."""
    rng = np.random.RandomState(SEED + 1)
    b, n = 8, 2000
    # dense: 20 objects per image, each detected 100 times with a few px of
    # jitter, so almost every box is suppressed by its object's first one
    objs = random_boxes(rng, b, 20)
    dense = np.repeat(objs, n // 20, axis=1)
    dense = dense + rng.randn(b, n, 4).astype(np.float32) * 2.0
    dense = np.take_along_axis(dense, np.argsort(rng.rand(b, n), 1)[..., None], 1)
    # sparse: one box in each cell of a 40 x 50 grid over the canvas, none
    # overlapping another, so every box is kept
    gy, gx = np.meshgrid(np.arange(40) * 20.0, np.arange(50) * 26.0,
                         indexing="ij")
    cells = np.stack([gx, gy, gx + 22.0, gy + 16.0], -1).reshape(1, n, 4)
    sparse = np.repeat(cells, b, axis=0) + rng.rand(b, n, 1) * 2.0
    sparse = np.take_along_axis(sparse, np.argsort(rng.rand(b, n), 1)[..., None], 1)
    return [_case("dense_b8", dense), _case("sparse_b8", sparse),
            _case("large_b1_n20000", random_boxes(rng, 1, 20000)),
            _case("large_b1_n30000", random_boxes(rng, 1, 30000))]


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
