"""The port's co-training multi-head detector against the JAX package.

The tiny config of ``tests/test_anchor_tier.py::test_multi_head_detector``
(ResNet-18, two FPN 32 / one-conv FCOS head 32 pairs, 4 classes), built in
both packages; the JAX variables (``jax.eval_shape`` plus the seeded numpy
fill) cross with ``jax_bridge``, whose ``necks_{i}`` / ``bbox_heads_{i}``
map onto ``necks.{i}`` / ``bbox_heads.{i}``. At 64x96, f32:

- head outputs of both heads within 1e-5 x the output's largest magnitude
  over the levels, at every level but the 1x2 one (stride 64), where each
  GroupNorm group (one channel of the 32-wide head) normalizes two values
  and f32 rounding is amplified: 5e-5 there (GroupNorm over near-equal
  values, as ``test_torch_port_modules.py::test_group_norm_grad_on_a_1x1_map``
  shows);
- ``multi_head_loss`` on the tiny semi batch: the same keys (the second
  head's suffixed ``_h1``), each within 1e-5 relative;
- ``multi_head_predict`` at B=2: the same valid count and labels, dets
  (boxes and scores) within 1e-4 absolute. The classifier bias is set so
  that every head has candidates and none lies within 1e-4 of
  ``score_thr`` (asserted);
- ``build_detector`` routes a config with ``necks`` / ``bbox_heads`` to the
  multi-head builder, in both packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models.detectors.multi_head import (
    multi_head_loss as j_loss, multi_head_predict as j_predict)
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.multi_head import (
    FCOSMultiHead, multi_head_loss, multi_head_predict)
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_batch import to_torch

torch.set_num_threads(2)

HEAD = dict(type="FCOSHead", num_classes=4, in_channels=32, stacked_convs=1,
            feat_channels=32, strides=[8, 16, 32, 64, 128], norm_on_bbox=True,
            centerness_on_reg=True, center_sampling=True)
CFG = dict(
    type="FCOSMultiHead",
    backbone=dict(type="ResNet", depth=18, out_indices=(0, 1, 2, 3)),
    necks=[dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
                start_level=1, add_extra_convs="on_output", num_outs=5,
                relu_before_extra_convs=True)] * 2,
    bbox_heads=[HEAD, dict(HEAD, loss_weight=3.0, soft_weight=1.0)],
    test_cfg=dict(nms_pre=50, score_thr=0.05, nms=dict(iou_threshold=0.6),
                  max_per_img=10))
HW = (64, 96)


@pytest.fixture(scope="module")
def pair():
    det, var = U.jax_detector_and_variables(CFG, seed=5, hw=HW)
    # a classifier prior that puts about a third of the scores over 0.05
    for hi in range(2):
        var["params"][f"bbox_heads_{hi}"]["conv_cls"]["bias"] = np.full(
            4, -2.6 - 0.2 * hi, np.float32)
    port = build_detector(copy.deepcopy(CFG))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


X = U.images(3, 2, HW)
SHAPES = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
FACTORS = np.asarray([[1.0] * 4, [0.5] * 4], np.float32)


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """JAX's head outputs and ``multi_head_predict`` on ``X``, one jit."""
    det, var, _ = pair

    def run(v, im, sh, sf):
        return det.apply(v, im), j_predict(det, v, im, img_shapes=sh,
                                           scale_factors=sf)

    return jax.jit(run)(var, jnp.asarray(X), jnp.asarray(SHAPES),
                        jnp.asarray(FACTORS))


def test_build_routes_and_names(pair):
    det, var, port = pair
    assert isinstance(port, FCOSMultiHead) and port.num_heads == 2
    assert "necks.1.fpn_convs.4.conv.weight" in port.state_dict()
    assert "bbox_heads.1.scales.4.scale" in port.state_dict()
    back = state_dict_to_flax(port.state_dict())
    assert sorted(back["params"]) == sorted(var["params"])
    np.testing.assert_array_equal(
        back["params"]["bbox_heads_1"]["conv_cls"]["kernel"],
        var["params"]["bbox_heads_1"]["conv_cls"]["kernel"])


def test_head_outputs_match_jax(pair, jax_outputs):
    want = jax_outputs[0]
    got = pair[2](U.nchw(X))
    assert len(got) == len(want) == 2
    for g_head, w_head in zip(got, want):
        for g_kind, w_kind in zip(g_head, w_head):
            top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
            for g, w in zip(g_kind, w_kind):
                w = np.asarray(w)
                tol = 5e-5 if w.shape[1:3] == (1, 2) else 1e-5
                np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                           atol=tol * top)


def test_loss_matches_jax(pair):
    det, var, _ = pair
    batch = U.semi_batch()
    _, want = jax.jit(lambda v, b: j_loss(det, v, b, cur_iter=10))(
        var, U.jax_batch(batch))
    port = build_detector(copy.deepcopy(CFG))
    port.load_state_dict(flax_to_state_dict(var))
    total, got = multi_head_loss(port, to_torch(batch, "cpu"), cur_iter=10)
    assert set(got) == set(want)
    assert {"loss_cls", "loss_cls_h1", "loss_sisoft_h1", "loss"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    total.backward()
    assert port.bbox_heads[1].conv_cls.weight.grad.abs().sum() > 0


def test_predict_matches_jax(pair, jax_outputs):
    port = pair[2]
    outs = port(U.nchw(X))
    for cls_scores, _, _ in outs:
        scores = torch.cat([torch.sigmoid(c).reshape(2, -1) for c in cls_scores], 1)
        assert (scores - 0.05).abs().min() > 1e-4
        assert (scores > 0.05).sum(1).min() > 20
    jd, jl, jv = jax_outputs[1]
    d, lab, v = multi_head_predict(port, U.nchw(X), torch.from_numpy(SHAPES),
                                   torch.from_numpy(FACTORS), device="cpu")
    assert d.shape == (2, 10, 5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert v.sum() > 10
    np.testing.assert_array_equal(lab.numpy()[v.numpy()], np.asarray(jl)[np.asarray(jv)])
    np.testing.assert_allclose(d.numpy()[v.numpy()], np.asarray(jd)[np.asarray(jv)],
                               rtol=0, atol=1e-4)
