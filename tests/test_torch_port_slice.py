"""The port's predict path against the JAX package on the tiny flagship
(``__graft_entry__._flagship_detector(tiny=True)``'s config) at B=2, 64x96.

Tolerances:
- ``fcos_get_bboxes`` fed identical head outputs: identical valid masks and
  labels, boxes and scores within 1e-4 (sigmoid and decode round
  differently by an ulp);
- whole ``detector_predict`` in f32: head outputs within rtol 1e-4 / atol
  1e-4 x the level's largest magnitude; the same valid count and labels;
  boxes within 1e-2 px; scores within 1e-4;
- head outputs in bf16 (every variable cast to bf16, BN statistics
  included, as ``compute_dtype`` does in JAX): within 3e-2 x the level's
  largest magnitude — bf16 keeps 8 bits of mantissa and the two frameworks
  round at different places through the depth.

The classifier is drawn so that no candidate lies within 1e-4 of
``score_thr`` (asserted below, not found by trying seeds): a threshold
decision that flips on an ulp would make the labels differ for no fault.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_util as U
from __graft_entry__ import _flagship_detector
from dsl_tpu.models.dense_heads.fcos_head import fcos_get_bboxes as j_get_bboxes
from dsl_tpu.models.detectors.single_stage import detector_predict as j_predict
from dsl_tpu_torch.models import detector_predict, fcos_get_bboxes
from dsl_tpu_torch.ops.nms import nms_keep

torch.set_num_threads(2)

CONFIG = str(Path(__file__).resolve().parent.parent
             / "configs/fcos_semi/RLA_r50_fcos_semi_dsl.py")
TEST_CFG = U.TINY_CFG["test_cfg"]
GET_BBOXES = dict(nms_pre=TEST_CFG["nms_pre"], score_thr=TEST_CFG["score_thr"],
                  iou_threshold=TEST_CFG["nms"]["iou_threshold"],
                  max_per_img=TEST_CFG["max_per_img"])


@pytest.fixture(scope="module")
def tiny():
    det, var = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    # the same model as the repo's own tiny flagship builder makes
    assert det == _flagship_detector(tiny=True)
    port = U.port_detector(U.TINY_CFG, var)
    x = U.images(1, 2, (64, 96))
    shapes = np.asarray([[64, 96], [50, 80]], np.float32)
    factors = np.asarray([[1.0, 1.0, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5]],
                         np.float32)
    return det, var, port, x, shapes, factors


@pytest.fixture(scope="module")
def jax_head(tiny):
    det, var, _, x, _, _ = tiny
    return _head_outputs_jax(det, var, x)


def _head_outputs_jax(det, var, x, dtype=None):
    from dsl_tpu.utils.precision import outputs_to_f32, to_compute

    def fwd(v, im):
        v, im = to_compute(v, im, dtype)
        return outputs_to_f32(det.apply(v, im, training=False))

    return jax.jit(fwd)(var, jnp.asarray(x))


def _head_outputs_port(port, x, dtype=None):
    from dsl_tpu_torch.utils.precision import outputs_to_f32, to_compute

    variables, im = to_compute(port, U.nchw(x), dtype)
    with torch.no_grad():
        return outputs_to_f32(torch.func.functional_call(port, variables, (im,)))


def _assert_levels(got, want, frac):
    for g_lvls, w_lvls in zip(got, want):
        for g, w in zip(g_lvls, w_lvls):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=frac,
                                       atol=frac * np.abs(w).max())


def _assert_clear_of_threshold(cls_scores, min_candidates):
    b = cls_scores[0].shape[0]
    scores = np.concatenate([np.asarray(jax.nn.sigmoid(c)).reshape(b, -1)
                             for c in cls_scores], 1)
    assert np.abs(scores - TEST_CFG["score_thr"]).min() > 1e-4
    assert (scores > TEST_CFG["score_thr"]).sum(1).min() > min_candidates


def test_candidates_clear_the_threshold(jax_head):
    _assert_clear_of_threshold(jax_head[0], 200)


def test_get_bboxes_identical_inputs(tiny, jax_head):
    det, _, port, _, shapes, factors = tiny
    outs = jax_head
    want = jax.jit(lambda o, sh, sf: j_get_bboxes(
        det.bbox_head, *o, img_shapes=sh, scale_factors=sf, **GET_BBOXES))(
        outs, jnp.asarray(shapes), jnp.asarray(factors))
    t_outs = tuple(tuple(torch.tensor(np.asarray(a)) for a in lvl)
                   for lvl in outs)
    got = fcos_get_bboxes(port.bbox_head, *t_outs,
                          img_shapes=torch.from_numpy(shapes),
                          scale_factors=torch.from_numpy(factors), **GET_BBOXES)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    assert got[2].sum() > 0


def test_predict_f32_matches_jax(tiny, jax_head):
    det, var, port, x, shapes, factors = tiny
    _assert_levels(_head_outputs_port(port, x), jax_head, 1e-4)
    want = jax.jit(lambda v, im, sh, sf: j_predict(
        det, v, im, img_shapes=sh, scale_factors=sf))(
        var, jnp.asarray(x), jnp.asarray(shapes), jnp.asarray(factors))
    dets, labels, valid = detector_predict(
        port, U.nchw(x), img_shapes=torch.from_numpy(shapes),
        scale_factors=torch.from_numpy(factors), device="cpu")
    assert dets.shape == (2, 100, 5)
    np.testing.assert_array_equal(valid.sum(1).numpy(),
                                  np.asarray(want[2]).sum(1))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    m = valid.numpy()
    np.testing.assert_allclose(dets.numpy()[m][:, :4], np.asarray(want[0])[m][:, :4],
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(dets.numpy()[m][:, 4], np.asarray(want[0])[m][:, 4],
                               rtol=0, atol=1e-4)


def test_predict_bf16_head_matches_jax(tiny):
    det, var, port, x, _, _ = tiny
    got = _head_outputs_port(port, x, torch.bfloat16)
    _assert_levels(got, _head_outputs_jax(det, var, x, jnp.bfloat16), 3e-2)
    dets, _, valid = detector_predict(port, U.nchw(x),
                                      compute_dtype=torch.bfloat16,
                                      device="cpu")
    assert np.isfinite(dets.numpy()).all() and valid.sum(1).min() > 0
    # the module itself stays f32: the cast is per call, as in JAX
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_predict_calls_nms_once_per_batch(tiny, monkeypatch):
    _, _, port, x, _, _ = tiny
    import dsl_tpu_torch.core.nms as core_nms

    calls = []

    def spy(boxes, valid, thr):
        calls.append(tuple(boxes.shape))
        return nms_keep(boxes, valid, thr)

    monkeypatch.setattr(core_nms, "nms_keep", spy)
    detector_predict(port, U.nchw(x), device="cpu")
    assert calls == [(2, 2000, 4)]


def test_entry_points_need_cuda_unless_asked_for_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    _, _, port, x, _, _ = tiny
    from dsl_tpu_torch.apis import init_detector

    with pytest.raises(RuntimeError, match="CUDA"):
        detector_predict(port, U.nchw(x))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector(CONFIG)


def test_predict_refuses_images_off_the_detectors_device(tiny):
    _, _, port, x, _, _ = tiny
    with pytest.raises(ValueError, match="images lie on meta"):
        detector_predict(port, U.nchw(x).to("meta"), device="cpu")


def _cv2_canvas(arr, canvas_hw):
    """The JAX package's preprocessing (``dsl_tpu/apis/inference.py``)."""
    import cv2

    h, w = arr.shape[:2]
    ch, cw = canvas_hw
    factor = min(1344 / max(h, w), 800 / min(h, w))
    nw, nh = int(w * factor + 0.5), int(h * factor + 0.5)
    out = cv2.resize(arr, (nw, nh)).astype(np.float32)
    mean = np.asarray([123.675, 116.28, 103.53], np.float32)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    out = (out[..., ::-1] - mean) / std
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:min(nh, ch), :min(nw, cw)] = out[:ch, :cw]
    return canvas, std


@pytest.mark.parametrize("hw", [(120, 200), (900, 1700)])
def test_resize_differs_from_cv2_by_at_most_one_level(tiny, hw):
    """``preprocess``'s resize is ``cv2.resize``'s fixed-point INTER_LINEAR
    bit for bit (``image_ops.resize_linear_u8``), on up- and down-scaling:
    the normalized canvas equals the JAX package's, 0 levels apart."""
    from dsl_tpu_torch.apis.inference import DetectorBundle, preprocess
    from dsl_tpu_torch.config import Config

    _, _, port, _, _, _ = tiny
    arr = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3)).astype(np.uint8)
    bundle = DetectorBundle(port, Config(dict(model=U.TINY_CFG)), (800, 1344))
    canvas, _, _ = preprocess(bundle, arr)
    want, _ = _cv2_canvas(arr, (800, 1344))
    np.testing.assert_array_equal(U.nhwc(canvas)[0], want)


def test_init_detector_random_init_on_cpu():
    """Without variables: mmdet's init (normal 0.01 head convs, the focal
    prior on the classifier bias, He-normal backbone convs)."""
    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models.layers import bias_init_with_prob

    bundle = init_detector(Config(dict(model=U.TINY_CFG)), device="cpu",
                           canvas_hw=(64, 96))
    head = bundle.detector.bbox_head
    np.testing.assert_allclose(head.conv_cls.bias.detach().numpy(),
                               bias_init_with_prob(0.01), rtol=1e-6)
    assert abs(float(head.conv_reg.weight.detach().std()) - 0.01) < 1e-3
    conv1 = bundle.detector.backbone.conv1.weight.detach()
    assert abs(float(conv1.std()) - np.sqrt(2.0 / conv1[0].numel())) < 0.02
    dets, _, _ = detector_predict(bundle.detector, U.nchw(U.images(0, 1, (64, 96))),
                                  device="cpu")
    assert dets.shape == (1, 100, 5) and torch.isfinite(dets).all()


def test_inference_detector_on_cpu(tiny):
    from dsl_tpu_torch.apis.inference import DetectorBundle, inference_detector
    from dsl_tpu_torch.config import Config

    _, _, port, _, _, _ = tiny
    bundle = DetectorBundle(port, Config(dict(model=U.TINY_CFG)), (64, 96))
    arr = np.random.RandomState(3).randint(0, 256, (48, 80, 3)).astype(np.uint8)
    result = inference_detector(bundle, arr)
    assert len(result) == 80
    assert sum(len(r) for r in result) > 0
    assert all(r.shape[1:] == (5,) for r in result)


@pytest.mark.slow
def test_full_width_predict_f32_matches_jax():
    """The flagship at full width (RLA-R50, FPN 256, 4-conv towers) at
    B=1, 128x192, same tolerances as the tiny f32 test."""
    cfg = U.full_cfg()
    det, var = U.jax_detector_and_variables(cfg, seed=1, hw=(128, 192))
    port = U.port_detector(cfg, var)
    x = U.images(5, 1, (128, 192))
    heads = _head_outputs_jax(det, var, x)
    _assert_clear_of_threshold(heads[0], 200)
    _assert_levels(_head_outputs_port(port, x), heads, 1e-4)
    want = jax.jit(lambda v, im: j_predict(det, v, im))(var, jnp.asarray(x))
    dets, labels, valid = detector_predict(port, U.nchw(x), device="cpu")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    m = valid.numpy()
    np.testing.assert_allclose(dets.numpy()[m], np.asarray(want[0])[m],
                               rtol=0, atol=1e-2)
