"""The port's Faster R-CNN parts against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
the tiny config ``synthetic_data.TINY_FASTER_RCNN`` (ResNet-18, FPN and
heads 32 wide, 20 classes), f32:

- anchors: exact (the RPN's and RetinaNet's generators, the legacy one);
- ``bbox2delta`` / ``delta2bbox`` with both coders (the stock and the
  legacy one), the clamp and the clip: 1e-6 relative (abs 1e-5 on pixel
  coordinates);
- ``max_iou_assign``: labels, indices and weights equal on integer boxes
  (ties), with invalid GTs, with and without the low-quality match;
- ``roi_align``: forward and the features' gradient within 1e-5, RoIs on
  the borders, past them, tiny and invalid, aligned and not;
  ``map_rois_to_levels`` equal and ``extract_roi_feats`` within 1e-5;
- the FPN's max-pool mode (and ``'on_input'``, in the Retina file);
- ``multiclass_nms`` with per-class boxes: equal labels and valid, dets
  within 1e-5;
- ``subsample_anchors`` and ``sample_rois`` fed JAX's uniform draws (whose
  ``1e6 + draw`` priorities tie often in f32): equal masks and order;
- ``rpn_loss`` and the RoI head's loss: 1e-5 relative;
- ``rpn_proposals`` and the detector's predict (slow: it compiles JAX's
  two-stage predict): boxes within 1e-4 plus
  1e-5 of their magnitude (the exp of deltas that differ by the two
  frameworks' conv rounding, about 1e-6, moves a 100-pixel box by more
  than 1e-4), labels and valid equal;
- the weight bridge both ways, whose ``shared_fc0`` row order shows on
  RoI features that are not symmetric;
- the four Faster R-CNN and RetinaNet configs as written build, with
  mmdet's parameter counts;
- one f32 SGD step (slow: it compiles JAX's step) with JAX's draws.
The train and test CLIs and ``inference_detector`` on the tiny VOC configs
of both detectors run in process.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.core import anchors as j_anchors
from dsl_tpu.core import boxes as j_boxes
from dsl_tpu.core.assigners import max_iou_assign as j_assign
from dsl_tpu.core.nms import multiclass_nms as j_mc_nms
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.dense_heads import rpn_head as j_rpn
from dsl_tpu.models.detectors.single_stage import (
    detector_predict as j_predict, init_detector_variables)
from dsl_tpu.models.necks.fpn import FPN as JFPN
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu.ops.roi_align import roi_align as j_roi_align
from dsl_tpu_torch.core import anchors, boxes
from dsl_tpu_torch.core.assigners import max_iou_assign
from dsl_tpu_torch.core.nms import multiclass_nms
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads import rpn_head
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.detectors.single_stage import detector_predict
from dsl_tpu_torch.models.necks.fpn import FPN
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.ops.roi_align import roi_align
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import TINY_FASTER_RCNN, TINY_RETINANET

torch.set_num_threads(2)

HW = (64, 96)
B = 2


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def detector_pair(cfg: dict, seed: int = 0):
    """The JAX detector, its seeded variables (every subtree, the RoI head's
    too) and the port's detector with them, in eval mode."""
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda r, x: init_detector_variables(det, r, x),
                            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    var = fill_variables(jax.tree_util.tree_map(lambda a: a, dict(shapes)),
                         seed)
    var = {k: U._plain(v) for k, v in var.items()}
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_FASTER_RCNN)


def gt_batch(seed: int, n_gt=(3, 5), k: int = 6, num_classes: int = 20):
    """GT in a (B, K) padded layout with integer corners, the last slot of
    the first image invalid where it is padding."""
    rng = np.random.RandomState(seed)
    h, w = HW
    gtb = np.zeros((len(n_gt), k, 4), np.float32)
    for i, n in enumerate(n_gt):
        for j in range(n):
            bw, bh = rng.randint(6, 60), rng.randint(6, 40)
            x1, y1 = rng.randint(0, w - bw + 1), rng.randint(0, h - bh + 1)
            gtb[i, j] = (x1, y1, x1 + bw, y1 + bh)
    valid = np.arange(k)[None] < np.asarray(n_gt)[:, None]
    labels = rng.randint(0, num_classes, (len(n_gt), k)).astype(np.int32)
    return dict(gt_bboxes=gtb, gt_labels=labels, gt_valid=valid,
                img_shapes=np.asarray([[64, 96], [60, 90]], np.float32))


def torch_batch(batch: dict) -> dict:
    return {k: t(v, torch.int64 if k == "gt_labels" else None)
            for k, v in batch.items()}


# -- core -------------------------------------------------------------------

@pytest.mark.parametrize("cfg,defaults", [
    (None, dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
                scales=[8.0])),
    (None, dict(strides=[8, 16, 32, 64, 128], ratios=[0.5, 1.0, 2.0],
                octave_base_scale=4, scales_per_octave=3)),
    (dict(type="LegacyAnchorGenerator", center_offset=0.5,
          strides=[8, 16], ratios=[0.5, 1.0, 2.0], scales=[4.0, 8.0]), {}),
], ids=["rpn", "retina", "legacy"])
def test_anchors_match_jax(cfg, defaults):
    sizes = [(13, 21), (7, 11), (4, 6), (2, 3), (1, 2)]
    want = j_anchors.anchor_generator_from_cfg(cfg, **defaults)
    got = anchors.anchor_generator_from_cfg(cfg, **defaults)
    sizes = sizes[:want.num_levels]
    assert got.num_base_anchors == want.num_base_anchors
    np.testing.assert_array_equal(got.flat_anchors(sizes).numpy(),
                                  np.asarray(want.flat_anchors(sizes)))
    for g, w in zip(got.grid_anchors(sizes), want.grid_anchors(sizes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ssd_anchors_raise():
    # SSD's generator is ported (tests/test_torch_port_ssd.py); as in the
    # JAX package it needs its per-level ratios, and has no single count
    with pytest.raises(KeyError, match="ratios"):
        anchors.anchor_generator_from_cfg(dict(type="SSDAnchorGenerator"))
    gen = anchors.anchor_generator_from_cfg(dict(
        type="SSDAnchorGenerator", strides=[8, 16, 32, 64, 100, 300],
        ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]]))
    with pytest.raises(AttributeError, match="num_base_anchors_level"):
        gen.num_base_anchors  # noqa: B018


@pytest.mark.parametrize("legacy", [False, True], ids=["stock", "legacy"])
def test_delta_coders_match_jax(legacy):
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 80, (200, 2))
    wh = rng.uniform(1, 60, (200, 2))
    props = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    gt = (props + rng.uniform(-8, 8, props.shape)).astype(np.float32)
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 0.5)
    means, stds = (0.0, 0.1, -0.1, 0.0), (0.1, 0.1, 0.2, 0.2)
    enc = j_boxes.legacy_bbox2delta if legacy else j_boxes.bbox2delta
    dec = j_boxes.legacy_delta2bbox if legacy else j_boxes.delta2bbox
    p_enc = boxes.legacy_bbox2delta if legacy else boxes.bbox2delta
    p_dec = boxes.legacy_delta2bbox if legacy else boxes.delta2bbox
    want = np.asarray(enc(jnp.asarray(props), jnp.asarray(gt), means, stds))
    got = p_enc(t(props), t(gt), means, stds).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # decode, with deltas past the +-log(1000/16) clamp, and a clip
    deltas = rng.randn(200, 4).astype(np.float32) * 3
    for k in (dict(), dict(max_shape=(50, 70))):
        want = np.asarray(dec(jnp.asarray(props), jnp.asarray(deltas), means,
                              stds, **k))
        got = p_dec(t(props), t(deltas), means, stds, **k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                                   err_msg=str(k))
    assert boxes.resolve_delta_coder(
        dict(type="LegacyDeltaXYWHBBoxCoder"))[0] is boxes.legacy_bbox2delta
    with pytest.raises(ValueError, match="TBLR"):
        boxes.resolve_delta_coder(dict(type="TBLRBBoxCoder"))


@pytest.mark.parametrize("low_quality", [True, False],
                         ids=["low_quality", "plain"])
def test_max_iou_assign_matches_jax(low_quality):
    gen = anchors.AnchorGenerator(strides=[8, 16], scales=[2.0, 4.0])
    anc = gen.flat_anchors([(8, 12), (4, 6)])
    batch = gt_batch(3)
    # two GTs equal to anchors, so best IoUs tie across GTs and anchors
    batch["gt_bboxes"][1, 3] = anc[5].numpy()
    batch["gt_bboxes"][1, 4] = anc[5].numpy()
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.1,
              num_classes=20, match_low_quality=low_quality)
    want = j_assign(jnp.asarray(anc.numpy()), jnp.asarray(batch["gt_bboxes"]),
                    jnp.asarray(batch["gt_labels"]),
                    jnp.asarray(batch["gt_valid"]), **kw)
    tb = torch_batch(batch)
    got = max_iou_assign(anc, tb["gt_bboxes"], tb["gt_labels"], tb["gt_valid"],
                         **kw)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6)
    assert (got[0] < 20).sum() > 4


def border_rois(seed: int, n: int, b: int, h: int, w: int, stride: float):
    """(n, 5) RoIs of every kind: inside, on and past the borders, tiny,
    degenerate; ``valid`` leaves a few out."""
    rng = np.random.RandomState(seed)
    H, W = h * stride, w * stride
    x1 = rng.uniform(-0.2 * W, W, n)
    y1 = rng.uniform(-0.2 * H, H, n)
    bw = np.exp(rng.uniform(np.log(0.5), np.log(W), n))
    bh = np.exp(rng.uniform(np.log(0.5), np.log(H), n))
    rois = np.stack([rng.randint(0, b, n), x1, y1, x1 + bw, y1 + bh], 1)
    rois[0, 1:] = (0, 0, W, H)                  # the whole map
    rois[1, 1:] = (W - 1, H - 1, W + 5, H + 5)  # past the bottom-right
    rois[2, 1:] = (3, 3, 3, 3)                  # zero size
    rois[3, 1:] = (-10, -10, -2, -2)            # outside, top-left
    valid = rng.rand(n) > 0.15
    return rois.astype(np.float32), valid


@pytest.mark.parametrize("aligned,scale", [(True, 0.25), (False, 0.125),
                                           (True, 0.3)],
                         ids=["aligned_s4", "unaligned_s8", "aligned_odd"])
def test_roi_align_matches_jax(aligned, scale):
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 9, 13, 5).astype(np.float32)     # NHWC, odd sizes
    rois, valid = border_rois(2, 40, 2, 9, 13, 1 / scale)
    cot = rng.randn(40, 7, 7, 5).astype(np.float32)

    def j_fn(f):
        out = j_roi_align(f, jnp.asarray(rois), (7, 7), scale, 2, aligned,
                          jnp.asarray(valid))
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jnp.asarray(feats))
    f = U.nchw(feats).requires_grad_(True)
    got = roi_align(f, t(rois), (7, 7), scale, 2, aligned, t(valid))
    (got * t(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(U.nhwc(f.grad), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)
    assert float(got.detach()[~t(valid)].abs().max()) == 0.0


def test_extract_roi_feats_matches_jax():
    rng = np.random.RandomState(4)
    strides = (4, 8, 16, 32)
    feats = [rng.randn(2, 64 // s, 96 // s, 6).astype(np.float32)
             for s in strides] + [rng.randn(2, 1, 2, 6).astype(np.float32)]
    rois, valid = border_rois(5, 60, 2, 16, 24, 4)
    # larger RoIs, for levels 1-3 (sqrt(area) 134, 274, 548)
    for lo, size in ((10, (150.0, 120.0)), (20, (300.0, 250.0)),
                     (30, (600.0, 500.0))):
        rois[lo:lo + 10, 3:] = rois[lo:lo + 10, 1:3] + np.asarray(size)
    lv_want = np.asarray(j_roi.map_rois_to_levels(jnp.asarray(rois[:, 1:]), 4))
    lv_got = roi.map_rois_to_levels(t(rois[:, 1:]), 4).numpy()
    np.testing.assert_array_equal(lv_got, lv_want)
    assert len(set(lv_got.tolist())) == 4
    want = jax.jit(lambda f, r, v: j_roi.extract_roi_feats(f, r, v, strides, 7))(
        [jnp.asarray(x) for x in feats], jnp.asarray(rois), jnp.asarray(valid))
    got = roi.extract_roi_feats([U.nchw(x) for x in feats], t(rois), t(valid),
                                strides, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def fpn_pair(cfg: dict, hw=HW):
    """A JAX FPN and the port's with the same seeded weights, and both
    outputs on one seeded input."""
    jfpn = JFPN(**{k: v for k, v in cfg.items() if k != "type"})
    rng = np.random.RandomState(7)
    ins = [rng.randn(2, hw[0] // s, hw[1] // s, c).astype(np.float32)
           for s, c in zip((4, 8, 16, 32), cfg["in_channels"])]
    shapes = jax.eval_shape(jfpn.init, jax.random.PRNGKey(0),
                            [jnp.asarray(x) for x in ins])
    var = fill_variables({"params": {"neck": U._plain(shapes["params"])}}, 3)
    want = jfpn.apply({"params": var["params"]["neck"]},
                      [jnp.asarray(x) for x in ins])
    port = FPN(**{k: v for k, v in cfg.items() if k != "type"})
    port.load_state_dict({k[len("neck."):]: v for k, v in
                          flax_to_state_dict(var).items()})
    got = port([U.nchw(x) for x in ins])
    return got, want


def test_fpn_max_pool_mode_matches_jax():
    got, want = fpn_pair(TINY_FASTER_RCNN["neck"])
    assert len(got) == len(want) == 5
    assert tuple(got[-1].shape[2:]) == (1, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(U.nhwc(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_multiclass_nms_per_class_boxes_matches_jax():
    rng = np.random.RandomState(6)
    p, c = 150, 5
    xy = rng.uniform(0, 60, (B, p, 1, 2))
    bx = np.concatenate([xy, xy + rng.uniform(8, 30, (B, p, 1, 2))], -1)
    bx = (bx + rng.uniform(-3, 3, (B, p, c, 4))).astype(np.float32)
    sc = rng.uniform(0, 0.3, (B, p, c)).astype(np.float32)
    valid = rng.rand(B, p) > 0.1
    want = jax.vmap(lambda b_, s_, v_: j_mc_nms(
        b_, s_, score_thr=0.05, iou_threshold=0.5, max_per_img=40,
        pre_nms_top=300, valid=v_))(jnp.asarray(bx), jnp.asarray(sc),
                                    jnp.asarray(valid))
    got = multiclass_nms(t(bx), t(sc), score_thr=0.05, iou_threshold=0.5,
                         max_per_img=40, pre_nms_top=300, valid=t(valid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    v = got[2].numpy()
    assert v.sum() > 40
    np.testing.assert_array_equal(got[1].numpy()[v], np.asarray(want[1])[v])
    np.testing.assert_allclose(got[0].numpy()[v], np.asarray(want[0])[v],
                               rtol=1e-5, atol=1e-5)


# -- samplers, fed JAX's draws ----------------------------------------------

def test_subsample_anchors_matches_jax_with_ties():
    rng = np.random.RandomState(8)
    a = 5000
    is_pos = rng.rand(B, a) < 0.03
    is_neg = ~is_pos & (rng.rand(B, a) < 0.8)
    key = jax.random.PRNGKey(11)
    draws = np.asarray(jax.random.uniform(key, (B, a)))
    # f32 1e6 + draw takes 16 values on [0, 1): the negatives' ranks tie
    assert len(np.unique(np.float32(1e6) + draws[0])) < 20
    want = j_rpn.subsample_anchors(key, jnp.asarray(is_pos),
                                   jnp.asarray(is_neg), 256, 0.5)
    got = rpn_head.subsample_anchors(t(draws), t(is_pos), t(is_neg), 256, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) == B * 256


def roi_samples_case(seed: int):
    rng = np.random.RandomState(seed)
    batch = gt_batch(seed)
    p = 300
    gtb = batch["gt_bboxes"]
    near = gtb[:, rng.randint(0, 3, p)] + rng.uniform(-6, 6, (B, p, 4))
    far = np.concatenate([rng.uniform(0, 60, (B, p, 2)),
                          rng.uniform(60, 96, (B, p, 2))], -1)
    props = np.where(rng.rand(B, p, 1) < 0.3, near, far).astype(np.float32)
    pvalid = rng.rand(B, p) > 0.1
    return batch, props, pvalid


def test_sample_rois_matches_jax_with_ties():
    batch, props, pvalid = roi_samples_case(9)
    key = jax.random.PRNGKey(5)
    jb = U.jax_batch(batch)
    want = jax.jit(lambda p_, v_, b_, k_: j_roi.sample_batch_rois(
        p_, v_, b_, k_, 20, num_samples=128))(
            jnp.asarray(props), jnp.asarray(pvalid), jb, key)
    keys = jax.random.split(key, B)
    draws = np.stack([np.asarray(jax.random.uniform(k, (props.shape[1] + 6,)))
                      for k in keys])
    got = roi.sample_batch_rois(t(props), t(pvalid), torch_batch(batch),
                                t(draws), 20, num_samples=128)
    for name in ("labels", "assigned", "valid", "is_pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(got["rois"].numpy(), np.asarray(want["rois"]))
    assert 4 < int(got["is_pos"].sum()) < int(got["valid"].sum())
    # with fewer candidates than samples, the rows past them pad invalid
    small = roi.sample_batch_rois(t(props[:, :50]), t(pvalid[:, :50]),
                                  torch_batch(batch), t(draws[:, :56]), 20,
                                  num_samples=128)
    assert not small["valid"][:, 56:].any()


# -- losses -----------------------------------------------------------------

def head_outputs(seed: int, sizes, channels):
    rng = np.random.RandomState(seed)
    return [tuple(rng.randn(B, h, w, c).astype(np.float32) for h, w in sizes)
            for c in channels]


SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]


def test_rpn_loss_matches_jax(pair):
    det, _, port = pair
    scores, deltas = head_outputs(10, SIZES, (3, 12))
    batch = gt_batch(10)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda s_, d_, b_, k_: j_rpn.rpn_loss(
        det.rpn_head, s_, d_, b_, rng_key=k_))(
            tuple(map(jnp.asarray, scores)), tuple(map(jnp.asarray, deltas)),
            U.jax_batch(batch), key)
    a = sum(h * w * 3 for h, w in SIZES)
    draws = np.asarray(jax.random.uniform(key, (B, a)))
    got = rpn_head.rpn_loss(port.rpn_head, [t(s) for s in scores],
                            [t(d) for d in deltas], torch_batch(batch),
                            t(draws))
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_roi_head_loss_matches_jax(pair):
    det, var, port = pair
    rng = np.random.RandomState(12)
    feats = [rng.randn(B, h, w, 32).astype(np.float32) for h, w in SIZES]
    batch, props, pvalid = roi_samples_case(12)
    key = jax.random.PRNGKey(2)

    def roi_apply(v, rf):
        return det.apply(v, rf, method=det.roi_forward)

    want = jax.jit(lambda v, f, p_, pv, b_, k_: j_roi.roi_head_loss(
        det.bbox_head, roi_apply, v, f, p_, pv, b_, k_, num_samples=64))(
            var, [jnp.asarray(f) for f in feats], jnp.asarray(props),
            jnp.asarray(pvalid), U.jax_batch(batch), key)
    keys = jax.random.split(key, B)
    draws = np.stack([np.asarray(jax.random.uniform(k, (props.shape[1] + 6,)))
                      for k in keys])
    tb = torch_batch(batch)
    samples = roi.sample_batch_rois(t(props), t(pvalid), tb, t(draws), 20,
                                    num_samples=64)
    head = port.bbox_head
    got = roi.roi_head_loss(head, head, [U.nchw(f) for f in feats], samples,
                            tb, (4, 8, 16, 32))
    assert set(got) == set(want) == {"loss_cls", "acc", "loss_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


# -- proposals and predict ---------------------------------------------------

X = U.images(3, B, HW)
SHAPES = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
FACTORS = np.asarray([[1.0] * 4, [0.5] * 4], np.float32)


def test_rpn_proposals_match_jax(pair):
    det, _, port = pair
    scores, deltas = head_outputs(15, SIZES, (3, 12))
    want = jax.jit(lambda s_, d_, sh: j_rpn.rpn_proposals(
        det.rpn_head, s_, d_, img_shapes=sh, nms_pre=200, num_proposals=150,
        min_bbox_size=2.0))(tuple(map(jnp.asarray, scores)),
                            tuple(map(jnp.asarray, deltas)),
                            jnp.asarray(SHAPES))
    got = rpn_head.rpn_proposals(port.rpn_head, [t(s) for s in scores],
                                 [t(d) for d in deltas], img_shapes=t(SHAPES),
                                 nms_pre=200, num_proposals=150,
                                 min_bbox_size=2.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() > 100
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)


@pytest.mark.slow
def test_predict_matches_jax(pair):
    det, var, port = pair
    want = j_predict(det, var, jnp.asarray(X), img_shapes=jnp.asarray(SHAPES),
                     scale_factors=jnp.asarray(FACTORS))
    d, lab, v = detector_predict(port, U.nchw(X), t(SHAPES), t(FACTORS),
                                 device="cpu")
    assert d.shape == (B, 100, 5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want[2]))
    assert v.sum(1).min() > 20
    np.testing.assert_array_equal(lab.numpy()[v.numpy()],
                                  np.asarray(want[1])[np.asarray(want[2])])
    np.testing.assert_allclose(d.numpy()[v.numpy()],
                               np.asarray(want[0])[np.asarray(want[2])],
                               rtol=1e-5, atol=1e-4)


# -- weights ------------------------------------------------------------------

def test_bridge_round_trip_and_shared_fc0_order(pair):
    det, var, port = pair
    sd = port.state_dict()
    assert "roi_head.bbox_head.shared_fcs.0.weight" in sd
    assert "rpn_head.rpn_reg.weight" in sd
    back = state_dict_to_flax(sd)
    assert sorted(back["params"]) == sorted(var["params"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(var["params"]):
        got = back["params"]
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    # the head on RoI features that differ across (c, h, w): the same
    # logits as JAX's, which flattens them (h, w, c)
    rf = np.random.RandomState(13).randn(6, 7, 7, 32).astype(np.float32)
    want = det.apply(var, jnp.asarray(rf), method=det.roi_forward)
    with torch.no_grad():
        got = port(U.nchw(rf), stage="roi")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # a plain transpose (no row permutation) would not agree
    plain = np.asarray(var["params"]["bbox_head"]["shared_fc0"]["kernel"]).T
    assert not np.allclose(plain, sd["roi_head.bbox_head.shared_fcs.0.weight"])


@pytest.mark.parametrize("config,kind,params", [
    ("configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py", "FasterRCNN", 41753056),
    ("configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py", "FasterRCNN", 41445556),
    ("configs/retinanet/retinanet_r50_fpn_1x_coco.py", "RetinaNet", 37968692),
    ("configs/pascal_voc/retinanet_r50_fpn_1x_voc0712.py", "RetinaNet", 36723992)],
    ids=["faster_rcnn_coco", "faster_rcnn_voc", "retinanet_coco",
         "retinanet_voc"])
def test_the_configs_build(config, kind, params):
    """The configs as written build, with mmdet's parameter counts (on the
    meta device: no weights are made)."""
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(config).model))
    assert type(det).__name__ == kind
    assert sum(p.numel() for p in det.parameters()) == params


def test_unported_two_stage_variants_raise():
    for change, match in (
            (dict(type="DoubleHeadRCNN"), "DoubleHeadRCNN"),
            (dict(type="GridRCNN"), "GridRCNN"),
            (dict(bbox_head=dict(type="SABLHead", num_classes=20)),
             "SABLHead"),
            (dict(bbox_head=dict(TINY_FASTER_RCNN["bbox_head"],
                                 loss_bbox=dict(type="CIoULoss"))), "CIoULoss"),
            (dict(bbox_head=dict(TINY_FASTER_RCNN["bbox_head"],
                                 type="DoubleConvFCBBoxHead")),
             "DoubleConvFCBBoxHead"),
            (dict(rpn_head=dict(type="GARPNHead")), "GARPNHead")):
        with pytest.raises(NotImplementedError, match=match):
            build_detector({**copy.deepcopy(TINY_FASTER_RCNN), **change})
    # a point head is PointRend's (ported: its own file)
    with pytest.raises(TypeError, match="point_head"):
        build_detector(dict(copy.deepcopy(TINY_FASTER_RCNN),
                            point_head=dict(type="MaskPointHead")))
    with pytest.raises(NotImplementedError, match="OHEMSampler"):
        two_stage.parse_rcnn_train_cfg(dict(rcnn=dict(
            sampler=dict(type="OHEMSampler"))))
    # SCNet is ported, as a cascade: one bbox head is not its config
    with pytest.raises(TypeError, match="bbox_heads"):
        build_detector(dict(copy.deepcopy(TINY_FASTER_RCNN), type="SCNet"))


def test_bf16_and_group_raise(pair):
    port = pair[2]
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        detector_predict(port, U.nchw(X), device="cpu",
                         compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="process group"):
        two_stage.check_two_stage(group=object())


# -- one SGD step, JAX's draws passed in -----------------------------------------

def jax_draws(cur_iter: int, b: int, num_anchors: int, num_cand: int) -> dict:
    """The uniforms JAX's two-stage loss draws at ``cur_iter``."""
    rng = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.asarray(cur_iter, jnp.uint32))
    rpn = jax.random.uniform(jax.random.fold_in(rng, 97), (b, num_anchors))
    rcnn = jnp.stack([jax.random.uniform(k, (num_cand,))
                      for k in jax.random.split(rng, b)])
    return dict(rpn=t(rpn), rcnn=(t(rcnn),))


def sgd_step_against_jax(cfg: dict, batch: dict, monkeypatch=None,
                         cur_iter: int = 0):
    """One f32 step of the train entry point in both packages from the same
    variables; returns (port metrics, JAX metrics, port state tree, JAX
    state tree, initial tree)."""
    from dsl_tpu.train import build_optimizer_from_cfg as j_opt
    from dsl_tpu.train import create_train_state as j_state
    from dsl_tpu.train import frozen_backbone_mask as j_frozen
    from dsl_tpu.train import make_train_step as j_step
    from dsl_tpu_torch.train import (
        build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
        make_train_step)
    from dsl_tpu_torch.train.bridge import train_state_to_jax
    from dsl_tpu_torch.utils.random_batch import to_torch

    det, var, port = detector_pair(cfg, seed=1)
    port.train()
    frozen = j_frozen(var["params"], 1)
    tx, _ = j_opt(var["params"], U.OPTIMIZER, U.OPTIMIZER_CONFIG, U.LR_CONFIG,
                  steps_per_epoch=U.STEPS_PER_EPOCH, frozen_mask=frozen)
    jstate = j_state(var, tx, ema_ratio=0.99)
    jstate = jstate.replace(step=jnp.asarray(cur_iter, jstate.step.dtype))
    jstate, want = jax.jit(j_step(det, tx, ema_interval=1, ema_start_iter=1,
                                  frozen_mask=frozen))(jstate,
                                                       U.jax_batch(batch))
    ptx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                      U.LR_CONFIG,
                                      steps_per_epoch=U.STEPS_PER_EPOCH)
    pstate = create_train_state(port, ptx, ema_ratio=0.99, device="cpu")
    pstate.step = cur_iter
    init = train_state_to_jax(pstate)
    step = make_train_step(port, ptx, ema_interval=1, ema_start_iter=1,
                           frozen_mask=frozen_backbone_mask(port, 1),
                           device="cpu")
    if monkeypatch is not None:
        monkeypatch.setattr(two_stage, "sampler_draws",
                            lambda it, b, a, n, dev: jax_draws(it, b, a, n))
    got = step(pstate, to_torch(batch, "cpu"))
    return got, want, train_state_to_jax(pstate), jstate, init


def train_batch(seed: int) -> dict:
    batch = gt_batch(seed)
    batch["images"] = U.images(seed, B, HW)
    return batch


@pytest.mark.slow
def test_sgd_step_matches_jax(monkeypatch):
    got, want, pstate, jstate, init = sgd_step_against_jax(
        TINY_FASTER_RCNN, train_batch(14), monkeypatch, cur_iter=7)
    assert set(got) == set(want) >= {"loss_rpn_cls", "loss_rpn_bbox",
                                     "loss_cls", "loss_bbox", "acc", "loss",
                                     "grad_norm"}
    for k in want:
        np.testing.assert_allclose(
            float(got[k]), float(want[k]),
            rtol=1e-3 if k == "grad_norm" else 1e-4, err_msg=k)
    frozen = U.frozen_tree(build_detector(copy.deepcopy(TINY_FASTER_RCNN)))
    assert U.assert_banded(pstate["params"],
                           jax.tree_util.tree_map(np.asarray, jstate.params),
                           init["params"], skip=frozen) > 20


def test_sampler_draws_repeat_per_iteration():
    a = two_stage.sampler_draws(3, 2, 100, 20, "cpu")
    b = two_stage.sampler_draws(3, 2, 100, 20, "cpu")
    c = two_stage.sampler_draws(4, 2, 100, 20, "cpu")
    assert torch.equal(a["rpn"], b["rpn"]) and len(a["rcnn"]) == 1
    assert torch.equal(a["rcnn"][0], b["rcnn"][0])
    assert not torch.equal(a["rpn"], c["rpn"])
    assert float(a["rpn"].min()) >= 0 and float(a["rpn"].max()) < 1


# -- the CLIs on the tiny VOC config ----------------------------------------------

def tiny_voc_config(model: dict, voc: dict, config: str) -> dict:
    """A ``configs/pascal_voc/`` detector config on a synthetic VOC
    directory with ``model`` in place of its own, at 64x96, one epoch."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.utils.synthetic_data import voc_detector_config

    cfg = voc_detector_config(Config.fromfile(config).to_dict(), voc)
    cfg["model"] = copy.deepcopy(model)
    for key in ("train", "val", "test"):
        for step in cfg["data"][key]["pipeline"]:
            for inner in [step] + step.get("transforms", []):
                if "img_scale" in inner:
                    inner["img_scale"] = (96, 64)
    cfg.update(canvas_hw=(64, 96), log_config=dict(interval=1),
               runner=dict(type="SemiEpochBasedRunner", max_epochs=1))
    cfg["data"]["workers_per_gpu"] = 1
    return cfg


@pytest.mark.parametrize("model,config", [
    (TINY_FASTER_RCNN, "configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py"),
    (TINY_RETINANET, "configs/pascal_voc/retinanet_r50_fpn_1x_voc0712.py")],
    ids=["faster_rcnn", "retinanet"])
def test_train_and_test_clis_on_tiny_voc(tmp_path, model, config):
    """One epoch through the train CLI (``train_detector``'s supervised
    branch, the evaluation after it), the test CLI's ``--eval mAP`` on its
    checkpoint, and ``inference_detector`` on it."""
    from torch_port_make_fixtures import FIXTURES, OUT

    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli
    from dsl_tpu_torch.tools import train as train_cli
    from dsl_tpu_torch.utils.synthetic_data import make_voc_dir

    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    voc = make_voc_dir(tmp_path / "voc", sources, n_trainval=4, n_test=3)
    cfg_path = str(tmp_path / "tiny_voc.py")
    Config(tiny_voc_config(model, voc, config)).dump(cfg_path)
    work = tmp_path / "work"
    train_cli.main([cfg_path, "--work-dir", str(work), "--device", "cpu"])
    log = [json.loads(line) for line in
           (work / "train.log.json").read_text().splitlines()]
    losses = [r for r in log if r.get("mode") == "train"]
    keys = ({"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc"}
            if "rpn_head" in model else {"loss_cls", "loss_bbox"})
    assert losses and all(np.isfinite(r["loss"]) for r in losses)
    assert keys <= set(losses[0])
    evals = [r for r in log if r.get("mode") == "val"]
    assert evals and 0.0 <= evals[-1]["mAP"] <= 1.0
    results, metrics = test_cli.main([cfg_path, str(work / "epoch_1.pth"),
                                      "--eval", "mAP", "--device", "cpu"])
    assert len(results) == 3 and 0.0 <= metrics["mAP"] <= 1.0
    bundle = init_detector(cfg_path, str(work / "epoch_1.pth"), device="cpu")
    per_class = inference_detector(bundle, sources[0][0])
    assert len(per_class) == 20
    assert all(r.shape[1:] == (5,) for r in per_class)
