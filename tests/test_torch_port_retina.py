"""The port's RetinaNet against the JAX package.

The tiny config ``synthetic_data.TINY_RETINANET`` (ResNet-18, FPN
``'on_input'`` and a 2-conv head 32 wide, 20 classes, 9 anchors) built in
both packages with seeded variables through the weight bridge, at 64x96:

- the FPN's ``'on_input'`` mode (its first extra conv reads C5): within
  1e-5;
- head outputs within 1e-5 x the largest magnitude over the levels;
- ``retina_loss`` on seeded GT (integer corners, a padded slot): each loss
  within 1e-5 relative;
- ``detector_predict`` (``retina_get_bboxes``): valid and labels equal,
  dets within 1e-4 plus 1e-5 of their magnitude; in bf16 it runs, finite,
  and differs from f32 (the casts took effect);
- the bridge both ways; the unported variants raise;
- one f32 SGD step (slow: it compiles JAX's step).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models.dense_heads.retina_head import retina_loss as j_loss
from dsl_tpu.models.detectors.single_stage import detector_predict as j_predict
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads.retina_head import retina_loss
from dsl_tpu_torch.models.detectors.single_stage import (
    detector_loss, detector_predict)
from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax
from dsl_tpu_torch.utils.synthetic_data import TINY_RETINANET
from test_torch_port_two_stage import (
    FACTORS, SHAPES, X, detector_pair, fpn_pair, gt_batch, sgd_step_against_jax,
    t, torch_batch, train_batch)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_RETINANET)


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """JAX's head outputs and predict on ``X``, one jit."""
    det, var, _ = pair

    def run(v, im, sh, sf):
        return det.apply(v, im), j_predict(det, v, im, img_shapes=sh,
                                           scale_factors=sf)

    return jax.jit(run)(var, jnp.asarray(X), jnp.asarray(SHAPES),
                        jnp.asarray(FACTORS))


def test_fpn_on_input_mode_matches_jax():
    got, want = fpn_pair(TINY_RETINANET["neck"])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(U.nhwc(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_head_outputs_match_jax(pair, jax_outputs):
    port = pair[2]
    want = jax_outputs[0]
    with torch.no_grad():
        got = port(U.nchw(X))
    for g_kind, w_kind in zip(got, want):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        for g, w in zip(g_kind, w_kind):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5 * top)


def test_loss_matches_jax(pair, jax_outputs):
    det, _, port = pair
    batch = gt_batch(21)
    outs = jax_outputs[0]
    want = jax.jit(lambda o, b: j_loss(det.bbox_head, *o, b))(
        outs, U.jax_batch(batch))
    got = retina_loss(port.bbox_head,
                      *[[t(x) for x in kind] for kind in outs],
                      torch_batch(batch))
    assert set(got) == set(want) == {"loss_cls", "loss_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    # through the detector's entry point, with gradients
    batch["images"] = X
    total, log_vars = detector_loss(port, {**torch_batch(batch),
                                           "images": U.nchw(X)})
    total.backward()
    assert port.bbox_head.retina_reg.weight.grad.abs().sum() > 0
    np.testing.assert_allclose(float(log_vars["loss_cls"]),
                               float(want["loss_cls"]), rtol=1e-5)


def test_predict_matches_jax(pair, jax_outputs):
    port = pair[2]
    want = jax_outputs[1]
    d, lab, v = detector_predict(port, U.nchw(X), t(SHAPES), t(FACTORS),
                                 device="cpu")
    wv = np.asarray(want[2])
    np.testing.assert_array_equal(v.numpy(), wv)
    assert v.sum(1).min() > 20
    np.testing.assert_array_equal(lab.numpy()[wv], np.asarray(want[1])[wv])
    np.testing.assert_allclose(d.numpy()[wv], np.asarray(want[0])[wv],
                               rtol=1e-5, atol=1e-4)
    d16, _, v16 = detector_predict(port, U.nchw(X), t(SHAPES), t(FACTORS),
                                   device="cpu", compute_dtype=torch.bfloat16)
    assert bool(torch.isfinite(d16).all()) and v16.sum() > 20
    assert not torch.equal(d16, d)


def test_bridge_round_trip(pair):
    _, var, port = pair
    sd = port.state_dict()
    assert "bbox_head.cls_convs.1.conv.weight" in sd
    assert "neck.fpn_convs.3.conv.weight" in sd          # the C5 extra conv
    assert sd["neck.fpn_convs.3.conv.weight"].shape[1] == 512
    back = state_dict_to_flax(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(var["params"]):
        got = back["params"]
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_unported_variants_raise():
    for change, match in (
            (dict(type="GARetinaHead"), "GARetinaHead"),
            (dict(loss_cls=dict(type="GHMC")), "GHMC"),
            (dict(loss_bbox=dict(type="GHMR")), "GHMR"),
            (dict(loss_bbox=dict(type="GIoULoss")), "GIoULoss")):
        cfg = copy.deepcopy(TINY_RETINANET)
        cfg["bbox_head"].update(change)
        with pytest.raises((NotImplementedError, KeyError), match=match):
            build_detector(cfg)


@pytest.mark.slow
def test_sgd_step_matches_jax():
    got, want, pstate, jstate, init = sgd_step_against_jax(
        TINY_RETINANET, train_batch(22))
    assert set(got) == set(want) >= {"loss_cls", "loss_bbox", "loss",
                                     "grad_norm"}
    for k in want:
        np.testing.assert_allclose(
            float(got[k]), float(want[k]),
            rtol=1e-3 if k == "grad_norm" else 1e-4, err_msg=k)
    frozen = U.frozen_tree(build_detector(copy.deepcopy(TINY_RETINANET)))
    assert U.assert_banded(pstate["params"],
                           jax.tree_util.tree_map(np.asarray, jstate.params),
                           init["params"], skip=frozen) > 20
