"""The port's SSD against the JAX package, and the float resize against
OpenCV.

Seeded numpy inputs and weights (``jax.eval_shape`` plus the port's numpy
fill, carried across by the weight bridge) through each JAX function and
its port, f32:

- SSD's anchor ladders (SSD300 on COCO and VOC, SSD512, the V1.x
  generator, explicit sizes): exact, with the per-level counts 4/6/6/6/4/4;
- ``max_iou_assign(gt_max_assign_all=False)`` on integer boxes (IoU ties,
  a GT whose best IoU several anchors share, invalid GTs): labels, indices
  and weights equal;
- ``ssd_loss`` on head outputs whose negatives tie at the hard-negative
  threshold (only those strictly above it are kept, as JAX keeps them):
  1e-5 relative; the mining's kept set equal;
- ``ssd_get_bboxes``: labels and valid equal, dets within 1e-4 plus 1e-5
  of their magnitude, compared as sets per image (candidates whose scores
  differ by the frameworks' rounding may swap in NMS order);
- the tiny SSD (``synthetic_data.TINY_SSD``: SSD's neck, head and ladder on
  a ResNet-18) head outputs within 1e-5 of their magnitude; its whole
  predict, and its losses (1e-5 relative) and trainable gradients (each
  leaf within 5e-3 of its largest magnitude: the rounding of two
  frameworks through the backbone's relus) are ``slow`` (eager JAX);
- SSD300's VGG-16 levels at 300x300: JAX's shapes (37, 18, 9, 5, 3, 1: its
  max pools floor, so 8096 anchors), and (``slow``) its features within
  1e-5 of their magnitude;
- ``SSDNeck`` with ``use_depthwise`` and BN: 1e-5;
- ``image_ops.resize_linear_f32`` against ``cv2.resize(INTER_LINEAR)`` on
  float32 images (OpenCV 5.0.0 with IPP, as installed): bit for bit at
  every down- and up-scale up to 8x per axis of a source two pixels wide
  and tall at least; past 8x the outermost columns and rows part by at
  most ``PAST_8X_ULPS`` ulps, and a source one pixel wide or tall (where
  OpenCV takes another path) by at most ``THIN_SOURCE_ULPS``, both logged
  in ROADMAP §3 as differences by design;
- SSD's float train pipeline (``PhotoMetricDistortion`` -> ``Expand`` ->
  ``MinIoURandomCrop`` -> ``Resize(keep_ratio=False)`` -> ``RandomFlip``
  -> ``Normalize``, the repo's SSD-300 protocol in
  ``configs/_base_/datasets/wider_face.py``, whose ``Expand(to_rgb=True)``
  neither package takes: ``synthetic_data.ssd_pipeline`` folds it into the
  mean) against the JAX package's transforms on the fixture decodes:
  images bit-identical, boxes equal.
"""

import copy
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.core import anchors as j_anchors
from dsl_tpu.core.assigners import max_iou_assign as j_assign
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.dense_heads import ssd_head as j_ssd
from dsl_tpu.registry import MODELS as J_MODELS, build_from_cfg as j_from_cfg
from dsl_tpu_torch.core import anchors
from dsl_tpu_torch.core.assigners import max_iou_assign
from dsl_tpu_torch.data.pipelines.image_ops import (
    RESIZE_F32_EXACT_UPSCALE, resize_linear_f32)
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads import ssd_head
from dsl_tpu_torch.models.detectors.single_stage import detector_predict
from dsl_tpu_torch.registry import MODELS, build_from_cfg
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import TINY_SSD
from torch_port_make_fixtures import FIXTURES, load_decodes

torch.set_num_threads(2)

B = 2
HW = (128, 128)
PAST_8X_ULPS = 32           # past an 8x upscale (30 measured at 30x)
THIN_SOURCE_ULPS = 256      # a source of one row or one column (222 measured)
DECODES = functools.lru_cache(maxsize=1)(load_decodes)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def close(got, want, tol: float, what: str = ""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


# -- anchors and assignment ---------------------------------------------------

SSD300 = dict(type="SSDAnchorGenerator", input_size=300,
              basesize_ratio_range=(0.15, 0.9),
              strides=[8, 16, 32, 64, 100, 300],
              ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]])
SSD512 = dict(type="SSDAnchorGenerator", input_size=512,
              basesize_ratio_range=(0.1, 0.9),
              strides=[8, 16, 32, 64, 128, 256, 512],
              ratios=[[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]])


@pytest.mark.parametrize("cfg", [
    SSD300, dict(SSD300, basesize_ratio_range=(0.2, 0.9)), SSD512,
    dict(SSD300, type="LegacySSDAnchorGenerator"),
    TINY_SSD["bbox_head"]["anchor_generator"]],
    ids=["ssd300", "ssd300_voc", "ssd512", "legacy", "explicit"])
def test_ssd_anchors_match_jax(cfg):
    want = j_anchors.anchor_generator_from_cfg(copy.deepcopy(cfg))
    got = anchors.anchor_generator_from_cfg(copy.deepcopy(cfg))
    sizes = [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1), (1, 1)]
    sizes = sizes[:want.num_levels]
    counts = [got.num_base_anchors_level(i) for i in range(got.num_levels)]
    assert counts == [want.num_base_anchors_level(i)
                      for i in range(want.num_levels)]
    if cfg is SSD300:
        assert counts == [4, 6, 6, 6, 4, 4]
    np.testing.assert_array_equal(got.flat_anchors(sizes).numpy(),
                                  np.asarray(want.flat_anchors(sizes)))
    with pytest.raises(AttributeError, match="num_base_anchors_level"):
        got.num_base_anchors  # noqa: B018


def tie_case(seed: int):
    """Anchors and GT on an integer grid: many IoU ties, a GT whose best IoU
    several anchors share, and padded (invalid) GT slots."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 40, (300, 2))
    wh = rng.choice([4, 8, 8, 16], (300, 2))
    anc = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    anc[150:200] = anc[100:150]                  # duplicated anchors: ties
    gt = np.zeros((B, 5, 4), np.float32)
    gt[:, :3] = anc[rng.randint(100, 150, (B, 3))]
    gt[:, 3] = [0, 0, 12, 12]
    # 1.5x a duplicated anchor: its best IoU (4/9) is below pos_iou_thr and
    # shared by the anchor and its copy, so the forced match decides
    a = anc[120]
    gt[:, 2] = [a[0], a[1], a[0] + 1.5 * (a[2] - a[0]),
                a[1] + 1.5 * (a[3] - a[1])]
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    labels = rng.randint(0, 20, (B, 5)).astype(np.int32)
    return anc, gt, labels, valid


@pytest.mark.parametrize("min_pos_iou", [0.0, 0.3])
def test_first_best_only_assigner_matches_jax_with_ties(min_pos_iou):
    anc, gt, labels, valid = tie_case(4)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=min_pos_iou,
              num_classes=20)
    want = j_assign(jnp.asarray(anc), jnp.asarray(gt), jnp.asarray(labels),
                    jnp.asarray(valid), gt_max_assign_all=False, **kw)
    got = max_iou_assign(t(anc), t(gt), t(labels, torch.int64), t(valid),
                         gt_max_assign_all=False, **kw)
    for name, g, w in zip(("labels", "assigned", "weights", "max_iou"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the duplicated anchors tie at a GT's best: only the first is forced
    every = max_iou_assign(t(anc), t(gt), t(labels, torch.int64), t(valid),
                           **kw)
    assert int((every[1] >= 0).sum()) > int((got[1] >= 0).sum())


def test_inside_mask_matches_jax():
    anc, gt, labels, valid = tie_case(6)
    inside = np.random.RandomState(1).rand(B, len(anc)) > 0.3
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.3,
              num_classes=1)
    want = j_assign(jnp.asarray(anc), jnp.asarray(gt), jnp.asarray(labels),
                    jnp.asarray(valid), inside=jnp.asarray(inside), **kw)
    got = max_iou_assign(t(anc), t(gt), t(labels, torch.int64), t(valid),
                         inside=t(inside), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # an anchor left out is neither positive nor negative
    assert not got[2].numpy()[~inside].any()


# -- the head, the loss and the decode -----------------------------------------

def heads():
    jhead = j_from_cfg(copy.deepcopy(TINY_SSD["bbox_head"]), J_MODELS)
    phead = build_from_cfg(copy.deepcopy(TINY_SSD["bbox_head"]), MODELS)
    return jhead, phead


SIZES = [(8, 8), (4, 4), (2, 2), (1, 1)]
COUNTS = [4, 6, 6, 4]


def head_outputs(seed: int, tied: bool):
    """Per level NHWC (cls, reg); with ``tied``, most anchors' class logits
    equal, so many negatives share one CE value at the mining threshold."""
    rng = np.random.RandomState(seed)
    cls, reg = [], []
    for (h, w), a in zip(SIZES, COUNTS):
        c = rng.randn(B, h, w, a * 21).astype(np.float32)
        if tied:
            flat = c.reshape(B, h, w, a, 21)
            flat[rng.rand(B, h, w, a) < 0.7] = np.linspace(3, -3, 21)
        cls.append(c)
        reg.append((0.5 * rng.randn(B, h, w, a * 4)).astype(np.float32))
    return cls, reg


def gt_batch(seed: int):
    rng = np.random.RandomState(seed)
    k = 6
    gtb = np.zeros((B, k, 4), np.float32)
    for i in range(B):
        for j in range(k):
            bw, bh = rng.randint(12, 90), rng.randint(12, 90)
            x1, y1 = rng.randint(0, 128 - bw), rng.randint(0, 128 - bh)
            gtb[i, j] = (x1, y1, x1 + bw, y1 + bh)
    valid = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    labels = rng.randint(0, 20, (B, k)).astype(np.int32)
    return dict(gt_bboxes=gtb, gt_labels=labels, gt_valid=valid)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "random"])
def test_ssd_loss_matches_jax(tied):
    jhead, phead = heads()
    cls, reg = head_outputs(7, tied)
    batch = gt_batch(7)
    want = jax.jit(lambda c_, r_, b_: j_ssd.ssd_loss(jhead, c_, r_, b_))(
        tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg)),
        U.jax_batch(batch))
    tb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    got = ssd_head.ssd_loss(phead, [t(c) for c in cls], [t(r) for r in reg],
                            tb)
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    if tied:
        # negatives tied at the threshold exist, and none of them is kept
        from dsl_tpu_torch.core import losses as L

        a = sum(h * w * n for (h, w), n in zip(SIZES, COUNTS))
        anc = phead.anchors.flat_anchors(SIZES)
        labels, _, weights, _ = max_iou_assign(
            anc, tb["gt_bboxes"], tb["gt_labels"], tb["gt_valid"],
            num_classes=20, pos_iou_thr=0.5, neg_iou_thr=0.5,
            gt_max_assign_all=False)
        ce = L.cross_entropy(torch.cat([t(c).reshape(B, -1, 21) for c in cls],
                                       1), labels, reduction="none")
        keep = ssd_head.hard_negative_weights(ce, labels, weights, 20, 3)
        neg = (labels == 20) & (weights > 0)
        n_pos = (labels < 20).sum(1)
        for i in range(B):
            thr = torch.sort(torch.where(neg[i], ce[i], -1e30),
                             descending=True).values[min(3 * n_pos[i], a - 1)]
            tied_at = neg[i] & (ce[i] == thr)
            assert int(tied_at.sum()) > 1 and not keep[i][tied_at].any()
            assert int(keep[i].sum()) < 3 * int(n_pos[i])


def det_sets_close(got, want, tol=1e-4):
    """Per image, the valid rows of dets + labels as sets, sorted by
    (label, x1, y1): equal labels, values within ``tol`` plus 1e-5 of their
    magnitude."""
    (gd, gl, gv), (wd, wl, wv) = got, want
    np.testing.assert_array_equal(gv, wv)
    for i in range(gd.shape[0]):
        rows = []
        for d, lab in ((gd[i][gv[i]], gl[i][gv[i]]),
                       (wd[i][wv[i]], wl[i][wv[i]])):
            order = np.lexsort((np.round(d[:, 1], 1), np.round(d[:, 0], 1),
                                lab))
            rows.append((d[order], lab[order]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=1e-5, atol=tol)


SHAPES = np.asarray([[128.0, 128.0], [120.0, 100.0]], np.float32)
FACTORS = np.asarray([[1.0] * 4, [0.5] * 4], np.float32)


def test_ssd_get_bboxes_matches_jax():
    jhead, phead = heads()
    cls, reg = head_outputs(9, False)
    for c in cls:
        flat = c.reshape(*c.shape[:3], -1, 21)
        flat[..., :8] += 3.0            # live classes well above score_thr
    kw = dict(nms_pre=100, score_thr=0.02, iou_threshold=0.45,
              max_per_img=200)
    want = jax.jit(lambda c_, r_, s_, f_: j_ssd.ssd_get_bboxes(
        jhead, c_, r_, img_shapes=s_, scale_factors=f_, **kw))(
            tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg)),
            jnp.asarray(SHAPES), jnp.asarray(FACTORS))
    got = ssd_head.ssd_get_bboxes(phead, [t(c) for c in cls],
                                  [t(r) for r in reg], img_shapes=t(SHAPES),
                                  scale_factors=t(FACTORS), **kw)
    assert got[0].shape == (B, 200, 5) and got[2].sum(1).min() > 100
    det_sets_close([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.fixture(scope="module")
def tiny_pair():
    det = j_build(copy.deepcopy(TINY_SSD))
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3)))
    var = fill_variables(U._plain(dict(shapes)), 0)
    port = build_detector(copy.deepcopy(TINY_SSD))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


X = U.images(3, B, HW)


def test_tiny_ssd_head_outputs_match_jax(tiny_pair):
    det, var, port = tiny_pair
    want = jax.jit(lambda v, x: det.apply(v, x))(var, jnp.asarray(X))
    with torch.no_grad():
        got = port(U.nchw(X))
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            close(g, w, 1e-5)
    assert [g.shape[-1] for g in got[0]] == [a * 21 for a in COUNTS]


@pytest.mark.slow
def test_tiny_ssd_predict_matches_jax(tiny_pair):
    from dsl_tpu.models.detectors.single_stage import (
        detector_predict as j_predict)

    det, var, port = tiny_pair
    want = j_predict(det, var, jnp.asarray(X), img_shapes=jnp.asarray(SHAPES),
                     scale_factors=jnp.asarray(FACTORS))
    got = detector_predict(port, U.nchw(X), t(SHAPES), t(FACTORS),
                           device="cpu")
    assert got[0].shape == (B, 200, 5) and got[2].sum(1).min() > 100
    det_sets_close([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.mark.slow
def test_tiny_ssd_loss_gradients_match_jax(tiny_pair):
    from dsl_tpu.models.detectors.single_stage import detector_loss as j_loss
    from dsl_tpu_torch.models.detectors.single_stage import detector_loss
    from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax

    det, var, port = tiny_pair
    batch = dict(gt_batch(11), images=X)

    def j_fn(params):
        return j_loss(det, dict(var, params=params), U.jax_batch(batch))

    (want, wlogs), wgrad = jax.value_and_grad(j_fn, has_aux=True)(
        var["params"])
    tb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    tb["images"] = U.nchw(X)
    port.zero_grad()
    total, logs = detector_loss(port.train(), tb)
    total.backward()
    port.eval()
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(logs[k]), float(wlogs[k]), rtol=1e-5)
    # the trainable parameters' gradients (the frozen stem has none here)
    grads = state_dict_to_flax({n: p.grad for n, p in port.named_parameters()
                                if p.grad is not None})["params"]
    assert "neck" in grads and "bbox_head" in grads
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        w = wgrad
        for p in path:
            w = w[p.key]
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=5e-3 * max(np.abs(w).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


# -- SSD300's VGG and the neck -------------------------------------------------

SSD300_VOC = "configs/pascal_voc/ssd300_voc0712.py"


def test_ssd300_levels_and_anchors_are_jax():
    from dsl_tpu_torch.config import Config

    cfg = dict(Config.fromfile(SSD300_VOC).model)
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda x: det.init_with_output(
        jax.random.PRNGKey(0), x)[0], jnp.zeros((1, 300, 300, 3)))
    want = [tuple(s.shape[1:3]) for s in shapes[0]]
    with torch.device("meta"):
        port = build_detector(cfg)
        got = port(torch.zeros(1, 3, 300, 300))
    assert [tuple(s.shape[1:3]) for s in got[0]] == want == [
        (37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
    head = port.bbox_head
    assert sum(h * w * head.anchors.num_base_anchors_level(i)
               for i, (h, w) in enumerate(want)) == 8096


@pytest.mark.slow
def test_ssd_vgg_matches_jax():
    x = U.images(5, 1, (300, 300))
    cfg = dict(type="SSDVGG", input_size=300, depth=16)
    jm = j_from_cfg(dict(cfg), J_MODELS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    var = fill_variables({"params": {"backbone": U._plain(shapes["params"])}},
                         2)
    pm = build_from_cfg(dict(cfg), MODELS)
    pm.load_state_dict({k[9:]: v for k, v in flax_to_state_dict(var).items()})
    want = jm.apply({"params": var["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(U.nchw(x))
    for g, w in zip(got, want):
        close(U.nhwc(g), w, 1e-5)


@pytest.mark.parametrize("depthwise", [True, False], ids=["depthwise", "plain"])
def test_ssd_neck_matches_jax(depthwise):
    cfg = dict(type="SSDNeck", in_channels=(16, 32),
               out_channels=(16, 32, 24, 16), level_strides=(2, 2),
               level_paddings=(1, 1), l2_norm_scale=20, last_kernel_size=3,
               use_depthwise=depthwise,
               norm_cfg=dict(type="BN") if depthwise else None)
    rng = np.random.RandomState(8)
    feats = [rng.randn(1, 8, 10, 16).astype(np.float32),
             rng.randn(1, 4, 5, 32).astype(np.float32)]
    jm = j_from_cfg(copy.deepcopy(cfg), J_MODELS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    var = fill_variables({c: {"neck": U._plain(v)} for c, v in shapes.items()},
                         3)
    pm = build_from_cfg(copy.deepcopy(cfg), MODELS)
    pm.load_state_dict({k[5:]: v for k, v in flax_to_state_dict(var).items()})
    want = jm.apply({c: v["neck"] for c, v in var.items()},
                    [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = pm([U.nchw(f) for f in feats])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(U.nhwc(g), w, 1e-5)


# -- the float resize ------------------------------------------------------------

RESIZE_CASES = [((375, 500), (300, 300)), ((500, 375), (300, 300)),
                ((375, 500), (512, 512)), ((112, 150), (300, 300)),
                ((427, 640), (800, 1199)), ((1500, 2000), (300, 300)),
                ((37, 53), (300, 300)), ((300, 300), (300, 300)),
                ((41, 7), (328, 56)), ((2, 5), (3, 9)), ((9, 900), (300, 300))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES,
                         ids=[f"{s[0]}x{s[1]}to{d[0]}x{d[1]}"
                              for s, d in RESIZE_CASES])
def test_float_resize_is_cv2(src, dst):
    rng = np.random.RandomState(src[0] * 7 + dst[1])
    img = (rng.randn(*src, 3) * 60 + 110).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear_f32(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_array_equal(got, want)


def test_float_resize_is_cv2_on_the_fixtures():
    for name in sorted(FIXTURES):
        img = DECODES()[name].astype(np.float32)
        for dst in ((300, 300), (512, 512), (219, 371)):
            want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
            got = resize_linear_f32(torch.from_numpy(img), *dst).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {dst}")


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("factor", [12, 30])
def test_float_resize_past_8x_is_within_the_stated_ulps(factor):
    assert RESIZE_F32_EXACT_UPSCALE == 8
    rng = np.random.RandomState(factor)
    img = (rng.rand(13, 17, 3) * 255).astype(np.float32)
    dst = (13 * factor, 17 * factor)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear_f32(torch.from_numpy(img), *dst).numpy()
    assert 0 < ulps(got, want).max() <= PAST_8X_ULPS
    # only columns and rows beyond the outer source centres part
    inner = np.s_[factor:-factor, factor:-factor]
    np.testing.assert_array_equal(got[inner], want[inner])


@pytest.mark.parametrize("src,dst", [((1, 17), (3, 40)), ((23, 1), (50, 4))],
                         ids=["one_row", "one_column"])
def test_float_resize_of_a_one_pixel_wide_source_is_within_the_stated_ulps(
        src, dst):
    rng = np.random.RandomState(src[1])
    img = (rng.rand(*src, 3) * 255).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear_f32(torch.from_numpy(img), *dst).numpy()
    assert 0 < ulps(got, want.reshape(got.shape)).max() <= THIN_SOURCE_ULPS


# -- SSD's float train pipeline ----------------------------------------------------

def ssd_pipeline():
    """The repo's SSD-300 train pipeline after its loading steps, with
    ``Expand``'s ``to_rgb`` folded into its mean (``ssd_pipeline``)."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.utils.synthetic_data import ssd_pipeline as build

    return build(Config.fromfile("configs/_base_/datasets/wider_face.py").get(
        "train_pipeline"))[2:]


@pytest.mark.parametrize("seed", range(6))
def test_ssd_train_pipeline_matches_jax(seed):
    from dsl_tpu.data.pipelines import Compose as JCompose
    from dsl_tpu_torch.data.pipelines import Compose

    name = sorted(FIXTURES)[seed % len(FIXTURES)]
    img = DECODES()[name].astype(np.float32)
    h, w = img.shape[:2]
    rng = np.random.RandomState(100 + seed)
    x1, y1 = rng.uniform(0, w * 0.6, 3), rng.uniform(0, h * 0.6, 3)
    boxes = np.stack([x1, y1, x1 + rng.uniform(20, w * 0.4, 3),
                      y1 + rng.uniform(20, h * 0.4, 3)], 1).astype(np.float32)
    base = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                gt_bboxes=boxes, gt_labels=np.arange(3, dtype=np.int64),
                gt_bboxes_ignore=np.zeros((0, 4), np.float32),
                bbox_fields=["gt_bboxes", "gt_bboxes_ignore"],
                img_fields=["img"])
    np.random.seed(seed)
    ref = JCompose(copy.deepcopy(ssd_pipeline()))(copy.deepcopy(base))
    gen = np.random.RandomState(seed)
    port = Compose(copy.deepcopy(ssd_pipeline()))(
        dict(copy.deepcopy(base), img=torch.from_numpy(img.copy())), gen)
    assert (port is None) == (ref is None)
    if ref is None:
        return
    got = port["img"].numpy()
    assert got.dtype == np.float32 and got.shape == ref["img"].shape == (
        300, 300, 3)
    np.testing.assert_array_equal(got, ref["img"])
    np.testing.assert_array_equal(port["gt_bboxes"], ref["gt_bboxes"])
    np.testing.assert_array_equal(port["gt_labels"], ref["gt_labels"])
    assert gen.rand() == np.random.rand(), "the generators parted"
