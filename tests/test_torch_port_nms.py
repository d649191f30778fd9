"""Port NMS family against the JAX package.

- ``nms_keep_reference`` (the CUDA kernel's plain version) against the
  Pallas kernel ``pallas_nms_keep`` in interpret mode: bit-identical keeps
  on every edge case with N <= 300 (the Pallas interpreter's cost bounds N);
- against the XLA Jacobi ``_greedy_keep`` up to N = 2001, bit-identical
  wherever the union is >= 1e-6 (the two floors agree there);
- one case of overlapping boxes with unions below 1e-6, where the 1e-10
  floor (kernel, reference) and the 1e-6 floor (``_greedy_keep``) part;
- the pairs of the ``iou_ulp`` cases land one ulp below, at and one ulp
  above the f32 threshold;
- ``nms``, ``batched_nms`` and ``multiclass_nms`` against JAX on random
  inputs with tied scores: equal labels and masks, values within 1e-6.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsl_tpu.ops.nms_pallas import pallas_nms_keep
from dsl_tpu_torch.core import nms as tnms
from dsl_tpu_torch.core.boxes import bbox_overlaps
from dsl_tpu_torch.ops import nms_cases
from dsl_tpu_torch.ops.nms import UNION_FLOOR, nms_keep, nms_keep_reference

torch.set_num_threads(2)

# `dsl_tpu.core` re-exports the function `nms`, which hides the module
jnms = importlib.import_module("dsl_tpu.core.nms")

SMALL = nms_cases.cases(max_n=300)
ALL = nms_cases.cases()


def _ref_keep(boxes, valid, thr):
    return nms_keep_reference(torch.from_numpy(boxes), torch.from_numpy(valid),
                              thr).numpy()


def _padded(boxes, valid, n):
    """Pad to n boxes with invalid rows (never kept, never suppress), so the
    JAX functions compile once for all cases."""
    pad = n - boxes.shape[1]
    return (np.pad(boxes, ((0, 0), (0, pad), (0, 0))),
            np.pad(valid, ((0, 0), (0, pad))))


def _jax_keep(fn, boxes, valid, thr, **kw):
    """Per-image keeps of a JAX (N,) keep function, padded to 384 or 2048."""
    n = boxes.shape[1]
    pb, pv = _padded(boxes, valid, 384 if n <= 384 else 2048)
    return np.stack([np.asarray(fn(jnp.asarray(pb[b]), jnp.asarray(pv[b]),
                                   thr, **kw))[:n]
                     for b in range(boxes.shape[0])])


@pytest.mark.parametrize("case", SMALL, ids=[c[0] for c in SMALL])
def test_reference_matches_pallas(case):
    _, boxes, valid, thr = case
    np.testing.assert_array_equal(
        _ref_keep(boxes, valid, thr),
        _jax_keep(pallas_nms_keep, boxes, valid, thr, interpret=True))


@pytest.mark.parametrize("case", ALL, ids=[c[0] for c in ALL])
def test_reference_matches_greedy_keep(case):
    name, boxes, valid, thr = case
    if name == "random_b8_n2000":       # two images keep the CPU test short
        boxes, valid = boxes[:2], valid[:2]
    np.testing.assert_array_equal(
        _ref_keep(boxes, valid, thr),
        _jax_keep(jnms._greedy_keep, boxes, valid, thr))


def test_union_floor_is_the_kernels():
    _, boxes, valid, thr = nms_cases.tiny_boxes()
    got = _ref_keep(boxes, valid, thr)
    pallas = _jax_keep(pallas_nms_keep, boxes, valid, thr, interpret=True)
    jacobi = _jax_keep(jnms._greedy_keep, boxes, valid, thr)
    np.testing.assert_array_equal(got, pallas)
    # with the 1e-6 floor these IoUs shrink below thr and nothing goes
    assert jacobi.all() and not got.all()


@pytest.mark.parametrize("thr", nms_cases.ULP_THRESHOLDS)
def test_threshold_pairs_straddle_the_threshold(thr):
    """The pairs of the iou_ulp cases land one ulp below, at and one ulp
    above the f32 threshold in the plain version's arithmetic."""
    boxes = nms_cases.threshold_pairs(np.random.RandomState(0), thr)[0]
    iou = torch.diagonal(bbox_overlaps(torch.from_numpy(boxes[0::2]),
                                       torch.from_numpy(boxes[1::2]),
                                       eps=UNION_FLOOR)).numpy()
    t = np.float32(thr)
    want = np.repeat([np.nextafter(t, np.float32(0)), t,
                      np.nextafter(t, np.float32(1))],
                     nms_cases.PAIRS_PER_TARGET)
    np.testing.assert_array_equal(iou, want)
    np.testing.assert_array_equal(
        iou, nms_cases.iou_f32(boxes[0::2], boxes[1::2]))


def test_nms_keep_takes_the_plain_version_on_cpu():
    _, boxes, valid, thr = nms_cases.cases(max_n=65)[1]
    before = nms_keep.launches
    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(got.numpy(), _ref_keep(boxes, valid, thr))
    assert nms_keep.launches == before


def test_nms_keep_checks_its_inputs():
    boxes = torch.zeros(2, 5, 4)
    valid = torch.ones(2, 5, dtype=torch.bool)
    with pytest.raises(TypeError):
        nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(TypeError):
        nms_keep(boxes, valid.float(), 0.5)
    with pytest.raises(ValueError):
        nms_keep(boxes[0], valid[0], 0.5)
    with pytest.raises(ValueError):
        nms_keep(boxes, valid[:, :4], 0.5)
    with pytest.raises(ValueError):
        nms_keep(boxes.to("meta"), valid.to("meta"), 0.5)


def _tied_inputs(seed, b, n, c=None):
    rng = np.random.RandomState(seed)
    boxes = nms_cases.random_boxes(rng, b, n, canvas=(200, 300))
    # few distinct values -> many exact ties in the score sort
    scores = (rng.randint(0, 6, (b, n) if c is None else (b, n, c))
              / 6.0).astype(np.float32)
    valid = rng.rand(b, n) > 0.2
    return boxes, scores, valid


def _assert_same(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out):
        j, t = np.asarray(j), t.numpy()
        if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_nms_matches_jax():
    boxes, scores, valid = _tied_inputs(1, 3, 300)
    want = jax.vmap(lambda bx, sc, vd: jnms.nms(bx, sc, 0.6, 100, vd))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.6, 100,
                   torch.from_numpy(valid))
    _assert_same(want, got)


def test_nms_pads_past_n():
    boxes, scores, valid = _tied_inputs(2, 2, 30)
    want = jax.vmap(lambda bx, sc, vd: jnms.nms(bx, sc, 0.5, 50, vd))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 50,
                   torch.from_numpy(valid))
    _assert_same(want, got)


def test_batched_nms_matches_jax():
    boxes, scores, valid = _tied_inputs(3, 3, 400)
    labels = np.random.RandomState(4).randint(0, 5, (3, 400)).astype(np.int32)
    want = jax.vmap(lambda bx, sc, lb, vd: jnms.batched_nms(bx, sc, lb, 0.6,
                                                            100, vd))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid))
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(labels).long(), 0.6, 100,
                           torch.from_numpy(valid))
    _assert_same(want, got)


def test_multiclass_nms_matches_jax():
    boxes, scores, valid = _tied_inputs(5, 2, 500, c=12)
    factors = np.random.RandomState(6).rand(2, 500).astype(np.float32)
    want = jax.vmap(lambda bx, sc, vd, f: jnms.multiclass_nms(
        bx, sc, score_thr=0.3, iou_threshold=0.6, max_per_img=100,
        pre_nms_top=1000, valid=vd, score_factors=f))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
        jnp.asarray(factors))
    got = tnms.multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                              score_thr=0.3, iou_threshold=0.6,
                              max_per_img=100, pre_nms_top=1000,
                              valid=torch.from_numpy(valid),
                              score_factors=torch.from_numpy(factors))
    _assert_same(want, got)


def test_soft_nms_waits_for_a_later_port():
    with pytest.raises(NotImplementedError):
        tnms.multiclass_nms(torch.zeros(1, 3, 4), torch.zeros(1, 3, 2),
                            nms_type="soft_nms")
    with pytest.raises(NotImplementedError):
        tnms.soft_nms()
