"""The port's box math, FCOS targets and losses against the JAX package.

Inputs come from seeds with numpy; boxes have integer corners, so some
pairs touch exactly or coincide (ties in max/min and in the IoU clip).

Tolerances:
- ``bbox_overlaps`` (aligned iou/giou), ``bbox2distance``,
  ``centerness_target``, ``fcos_targets``' box targets: within 1e-6
  (relative, atol 1e-6); labels and ``ignore_weight`` identical;
- loss values within 1e-5 relative, their gradients (``jax.grad`` against
  autograd) within 1e-5 relative and 1e-7 absolute: the same f32 formulas,
  summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsl_tpu.core import boxes as jboxes
from dsl_tpu.core import losses as jlosses
from dsl_tpu.core import targets as jtargets
from dsl_tpu.core.points import MlvlPointGenerator as JPoints
from dsl_tpu_torch.core import boxes as tboxes
from dsl_tpu_torch.core import losses as tlosses
from dsl_tpu_torch.core import targets as ttargets
from dsl_tpu_torch.core.points import MlvlPointGenerator

torch.set_num_threads(2)

STRIDES = [8, 16, 32, 64, 128]
RANGES = [(-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8)]
SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]           # a 64x96 canvas


def _int_boxes(rng, n, hw=(64, 96), side=(1, 40)):
    w = rng.randint(side[0], side[1] + 1, n)
    h = rng.randint(side[0], side[1] + 1, n)
    x1 = rng.randint(0, hw[1] - side[0], n)
    y1 = rng.randint(0, hw[0] - side[0], n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _box_pairs(seed=0, n=64):
    """Random pairs, then pairs that touch on an edge, coincide, nest and
    are degenerate (zero width)."""
    rng = np.random.RandomState(seed)
    a, b = _int_boxes(rng, n), _int_boxes(rng, n)
    b[:8] = a[:8]                                             # identical
    b[8:16, 0] = a[8:16, 2]                                   # touch on x
    b[8:16, 2] = b[8:16, 0] + 5
    b[16:24] = a[16:24] + np.asarray([1, 1, -1, -1], np.float32)
    a[24:28, 2] = a[24:28, 0]                                 # zero width
    return a, b


@pytest.mark.parametrize("mode", ["iou", "giou"])
def test_aligned_overlaps_and_grads(mode):
    a, b = _box_pairs()

    def jf(x):
        return jnp.sum(jboxes.bbox_overlaps(x, b, mode=mode, is_aligned=True)
                       * jnp.arange(len(b)))

    ta = torch.tensor(a, requires_grad=True)
    got = tboxes.bbox_overlaps(ta, torch.tensor(b), mode=mode, is_aligned=True)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jboxes.bbox_overlaps(a, b, mode=mode, is_aligned=True)),
        rtol=1e-6, atol=1e-6)
    (got * torch.arange(len(b))).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jax.grad(jf)(a)),
                               rtol=1e-5, atol=1e-7)


def test_bbox2distance():
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 96, (50, 2)).astype(np.float32)
    box = _int_boxes(rng, 50)
    for max_dis in (None, 20.0):
        np.testing.assert_allclose(
            tboxes.bbox2distance(torch.tensor(pts), torch.tensor(box),
                                 max_dis).numpy(),
            np.asarray(jboxes.bbox2distance(pts, box, max_dis)),
            rtol=1e-6, atol=1e-6)


def _gt(seed=2, b=3, k=8):
    rng = np.random.RandomState(seed)
    boxes = _int_boxes(rng, b * k, side=(4, 60)).reshape(b, k, 4)
    labels = rng.randint(0, 80, (b, k)).astype(np.int32)
    valid = np.ones((b, k), bool)
    valid[0, 5:] = False                          # K-padded
    valid[1] = False                              # an image with no GT
    boxes[0, 5:] = 0.0
    # duplicates with other labels: equal areas, the first index must win
    boxes[2, 1] = boxes[2, 0]
    boxes[2, 2] = boxes[2, 0]
    labels[2, :3] = (5, 6, 7)
    return boxes, labels, valid


def _point_metadata():
    points = JPoints(STRIDES).flat_points(SIZES)
    stride, ranges = jtargets.expand_point_metadata(SIZES, STRIDES, RANGES)
    tpoints = MlvlPointGenerator(STRIDES).flat_points(SIZES)
    tstride, tranges = ttargets.expand_point_metadata(SIZES, STRIDES, RANGES)
    np.testing.assert_array_equal(tpoints.numpy(), np.asarray(points))
    np.testing.assert_array_equal(tstride.numpy(), np.asarray(stride))
    np.testing.assert_array_equal(tranges.numpy(), np.asarray(ranges))
    return (points, ranges, stride), (tpoints, tranges, tstride)


@pytest.mark.parametrize("center_sampling", [True, False])
@pytest.mark.parametrize("norm_on_bbox", [True, False])
def test_fcos_targets(center_sampling, norm_on_bbox):
    boxes, labels, valid = _gt()
    jmeta, tmeta = _point_metadata()
    kw = dict(num_classes=80, center_sampling=center_sampling,
              center_sample_radius=1.5, norm_on_bbox=norm_on_bbox)
    jl, jt = jtargets.fcos_targets(*jmeta, boxes, labels, valid, **kw)
    tl, tt = ttargets.fcos_targets(*tmeta, torch.tensor(boxes),
                                   torch.tensor(labels), torch.tensor(valid),
                                   **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-6)
    assert (tl[1] == 80).all(), "an image with no GT is all background"
    assert (tl[0] < 80).any() and (tl[2] < 80).any()
    # the duplicates' points take the first box's label
    dup = tl[2][np.isin(tl[2].numpy(), (5, 6, 7))]
    assert dup.numel() > 0 and (dup == 5).all()


def test_centerness_and_ignore_weight():
    rng = np.random.RandomState(3)
    t = rng.uniform(-5, 30, (4, 200, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ttargets.centerness_target(torch.tensor(t)).numpy(),
        np.asarray(jtargets.centerness_target(t)), rtol=1e-6, atol=1e-6)
    labels = rng.randint(0, 81, (4, 200))
    ig = rng.choice([3, 80], (4, 200))
    np.testing.assert_array_equal(
        ttargets.ignore_weight(torch.tensor(labels), torch.tensor(ig),
                               80).numpy(),
        np.asarray(jtargets.ignore_weight(labels, ig, 80)))


def _loss_inputs(seed=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 40, 6).astype(np.float32) * 3
    logits[0, 0, 0] = 0.0                         # max(x, 0) at its tie
    labels = rng.randint(0, 7, (2, 40)).astype(np.int32)   # 6 = background
    weight = rng.uniform(0, 3, (2, 40)).astype(np.float32)
    a, b = _box_pairs(seed, 80)
    return logits, labels, weight, a.reshape(2, 40, 4), b.reshape(2, 40, 4)


LOSSES = {
    "focal": (lambda m, x, lab, w, bx, by: m.sigmoid_focal_loss(
        x, lab, weight=w, avg_factor=7.0)),
    "focal_soft": (lambda m, x, lab, w, bx, by: m.sigmoid_focal_loss(
        x, lab, gamma=1.5, alpha=0.3, reduction="sum")),
    "bce": (lambda m, x, lab, w, bx, by: m.binary_cross_entropy(
        x[..., 0], w / 3, weight=w)),
    "giou": (lambda m, x, lab, w, bx, by: m.giou_loss(
        bx, by, weight=w, avg_factor=5.0)),
    "iou": (lambda m, x, lab, w, bx, by: m.iou_loss(bx, by, weight=w)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_values_and_grads(name):
    fn = LOSSES[name]
    logits, labels, weight, a, b = _loss_inputs()
    if name == "focal_soft":
        labels = np.random.RandomState(5).uniform(0, 1, logits.shape).astype(
            np.float32)

    def jloss(x, bx):
        return fn(jlosses, x, labels, weight, bx, b)

    want = jloss(logits, a)
    jgx, jgb = jax.grad(jloss, argnums=(0, 1))(logits, a)
    tx = torch.tensor(logits, requires_grad=True)
    tb = torch.tensor(a, requires_grad=True)
    got = fn(tlosses, tx, torch.tensor(labels), torch.tensor(weight), tb,
             torch.tensor(b))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    for g, w in ((tx.grad, jgx), (tb.grad, jgb)):
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
