"""The Faster R-CNN / RetinaNet / RPN variants of the port against the JAX
package.

Seeded numpy inputs and weights (``jax.eval_shape`` plus the port's numpy
fill, carried across by the weight bridge) through each JAX function and
its port, f32:

- ResNeXt's grouped, widened bottlenecks, ResNet-V1d's deep stem and
  average-pool shortcuts, and a ConvWS + GN ResNet: the backbone's levels
  within 1e-5 of their magnitude;
- ``WSConv`` (ConvWS) forward within 1e-5 and its kernel gradient within
  1e-4 relative, a kernel of zero spread included (the std's
  ``sqrt(var + 1e-12)`` keeps it finite);
- the FPN with ConvWS and GroupNorm, and ``Shared4Conv1FCBBoxHead`` (4
  ConvWS + GN convs, one FC) on RoI features that are not symmetric:
  1e-5;
- the IoU, GIoU and BoundedIoU RoI losses on decoded boxes
  (``reg_decoded_bbox``): value 1e-5 relative, gradient 1e-4;
- the standalone RPN: ``rpn_only_predict`` (proposals within 1e-4 plus
  1e-5 of their magnitude, valid equal) and the RPN loss with
  ``allowed_border`` 0 and SmoothL1 fed JAX's draws (1e-5 relative; the
  ``inside`` filter equal to JAX's);
- ``fast_rcnn_predict`` on proposals passed in: labels and valid equal,
  dets within 1e-4 plus 1e-5 of their magnitude, compared as sets per
  image (candidates whose scores differ by the frameworks' rounding may
  swap in NMS order);
- ``LoadProposals`` through ``RandomFlip`` and ``Resize``: proposals equal
  to the JAX pipeline's;
- RetinaNet with SmoothL1 (the V1.x config's): the loss 1e-5 relative;
- the weight bridge and the configs this slice unlocks:
  ``test_torch_port_variant_weights.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.detectors import two_stage as j_two_stage
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.models.dense_heads import rpn_head as j_rpn
from dsl_tpu.models.dense_heads.retina_head import retina_loss as j_retina_loss
from dsl_tpu.models.layers import WSConv as JWSConv
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu.registry import MODELS as J_MODELS, build_from_cfg as j_from_cfg
from dsl_tpu_torch.core.assigners import anchor_inside_flags
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads import rpn_head
from dsl_tpu_torch.models.dense_heads.retina_head import retina_loss
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.detectors.single_stage import detector_predict
from dsl_tpu_torch.models.layers import WSConv
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.registry import MODELS, build_from_cfg
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_FAST_RCNN, TINY_FASTER_RCNN, TINY_GN_WS_RCNN, TINY_RESNEXT_RCNN,
    TINY_RETINANET, TINY_RPN)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
X = U.images(3, B, HW)
SHAPES = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
FACTORS = np.asarray([[1.0] * 4, [0.5] * 4], np.float32)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def module_pair(cfg: dict, x_shape, key: str):
    """A JAX module and the port's, both from ``cfg``, with one seeded set
    of weights carried across under the top-level name ``key``."""
    jm = j_from_cfg(copy.deepcopy(cfg), J_MODELS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32))
    var = fill_variables({c: {key: U._plain(v)} for c, v in shapes.items()}, 4)
    pm = build_from_cfg(copy.deepcopy(cfg), MODELS)
    sd = flax_to_state_dict(var)
    # (a RoI head's names come back under roi_head.bbox_head)
    pm.load_state_dict({k.split(f"{key}.", 1)[1]: v for k, v in sd.items()})
    jvar = {c: v[key] for c, v in var.items()}
    return jm, jvar, pm.eval()


def detector_pair(cfg: dict, seed: int = 0, hw=HW):
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda r, x: init_detector_variables(det, r, x),
                            jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    var = {k: U._plain(v) for k, v in fill_variables(
        U._plain(dict(shapes)), seed).items()}
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


def close(got: torch.Tensor, want, tol: float, what: str = ""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


# -- backbones and layers ------------------------------------------------------

V1D = dict(type="ResNetV1d", depth=18, stem_channels=32, frozen_stages=1)


@pytest.mark.parametrize("cfg", [
    dict(TINY_RESNEXT_RCNN["backbone"], num_stages=2, out_indices=(0, 1)),
    dict(V1D, num_stages=2, out_indices=(0, 1)),
    pytest.param(TINY_GN_WS_RCNN["backbone"], marks=pytest.mark.slow)],
    ids=["resnext", "v1d", "gn_ws"])
def test_grouped_v1d_and_ws_backbones_match_jax(cfg):
    x = U.images(21, 1, HW)
    jm, jvar, pm = module_pair(cfg, x.shape, "backbone")
    want = jm.apply(jvar, jnp.asarray(x))
    with torch.no_grad():
        got = pm(U.nchw(x))
    assert len(got) == len(want) == len(cfg.get("out_indices", range(4)))
    for i, (g, w) in enumerate(zip(got, want)):
        close(torch.as_tensor(U.nhwc(g)), w, 1e-5, f"level {i}")
    if cfg.get("groups"):
        assert pm.layer1[0].conv2.groups == cfg["groups"]
    if cfg["type"] == "ResNetV1d":
        assert len(pm.stem) == 9 and pm.layer2[0].downsample.stride == 2


def test_v1d_predict_on_a_tiny_config():
    cfg = copy.deepcopy(TINY_FASTER_RCNN)
    cfg["backbone"] = V1D
    det = build_detector(cfg)
    det.init_weights(torch.Generator().manual_seed(0))
    dets, labels, valid = detector_predict(det.eval(), U.nchw(U.images(2, B, HW)),
                                           t(SHAPES), device="cpu")
    assert dets.shape == (B, 100, 5) and bool(torch.isfinite(dets).all())


@pytest.mark.parametrize("spread", [True, False], ids=["random", "zero_spread"])
def test_wsconv_and_its_gradient_match_jax(spread):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    kernel = rng.randn(3, 3, 4, 6).astype(np.float32)
    if not spread:
        kernel[..., 2] = 0.75           # one output channel of zero spread
    bias = rng.randn(6).astype(np.float32)
    jm = JWSConv(6, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                 feature_group_count=2, use_bias=True)
    params = {"params": {"kernel": jnp.asarray(kernel),
                         "bias": jnp.asarray(bias)}}
    g_out = rng.randn(2, 5, 6, 6).astype(np.float32)

    def j_fn(k):
        p = {"params": {"kernel": k, "bias": jnp.asarray(bias)}}
        return jnp.sum(jm.apply(p, jnp.asarray(x)) * jnp.asarray(g_out))

    want = jm.apply(params, jnp.asarray(x))
    want_grad = np.asarray(jax.grad(j_fn)(jnp.asarray(kernel)))
    conv = WSConv(8, 6, 3, stride=2, padding=1, groups=2)
    with torch.no_grad():
        conv.weight.copy_(t(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(t(bias))
    got = conv(U.nchw(x))
    close(torch.as_tensor(U.nhwc(got)), want, 1e-5)
    (got * U.nchw(g_out)).sum().backward()
    grad = conv.weight.grad.numpy().transpose(2, 3, 1, 0)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(want_grad).max())


@pytest.mark.slow
def test_fpn_with_ws_and_gn_matches_jax():
    cfg = TINY_GN_WS_RCNN["neck"]
    rng = np.random.RandomState(5)
    feats = [rng.randn(1, 16 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(cfg["in_channels"])]
    jm = j_from_cfg(copy.deepcopy(cfg), J_MODELS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    var = fill_variables({c: {"neck": U._plain(v)}
                          for c, v in shapes.items()}, 6)
    pm = build_from_cfg(copy.deepcopy(cfg), MODELS)
    sd = flax_to_state_dict(var)
    assert "neck.fpn_convs.2.gn.weight" in sd and "neck.fpn_convs.2.conv.bias" not in sd
    pm.load_state_dict({k[5:]: v for k, v in sd.items()})
    want = jm.apply({"params": var["params"]["neck"]},
                    [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = pm([U.nchw(f) for f in feats])
    for g, w in zip(got, want):
        close(torch.as_tensor(U.nhwc(g)), w, 1e-5)


def test_shared4conv1fc_matches_jax():
    rf = np.random.RandomState(13).randn(6, 7, 7, 32).astype(np.float32)
    jm, jvar, head = module_pair(TINY_GN_WS_RCNN["bbox_head"], rf.shape,
                                 "bbox_head")
    want = jm.apply(jvar, jnp.asarray(rf))
    with torch.no_grad():
        got = head(U.nchw(rf))
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    assert "shared_convs.3.gn.weight" in head.state_dict()
    assert type(head.shared_convs[0].conv) is WSConv


# -- the IoU-family RoI losses -------------------------------------------------

def decoded_loss_case(seed: int):
    rng = np.random.RandomState(seed)
    n, nc = 40, 20
    rois = np.concatenate([rng.uniform(0, 50, (n, 2)),
                           rng.uniform(55, 96, (n, 2))], 1).astype(np.float32)
    gtb = np.zeros((B, 6, 4), np.float32)
    gtb[..., :2] = rng.uniform(0, 40, (B, 6, 2))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(10, 50, (B, 6, 2))
    samples = dict(
        rois=rois.reshape(B, n // B, 4),
        labels=rng.randint(0, nc + 1, (B, n // B)),
        assigned=rng.randint(-1, 6, (B, n // B)),
        valid=rng.rand(B, n // B) > 0.1)
    samples["is_pos"] = samples["valid"] & (samples["labels"] < nc)
    cls = rng.randn(n, nc + 1).astype(np.float32)
    reg = (0.3 * rng.randn(n, nc * 4)).astype(np.float32)
    return samples, dict(gt_bboxes=gtb), cls, reg


@pytest.mark.parametrize("kind", ["IoULoss", "GIoULoss", "BoundedIoULoss"])
def test_iou_family_rcnn_loss_matches_jax(kind):
    cfg = dict(TINY_FASTER_RCNN["bbox_head"], reg_decoded_bbox=True,
               loss_bbox=dict(type=kind, loss_weight=10.0))
    jhead = j_from_cfg(copy.deepcopy(cfg), J_MODELS)
    phead = build_from_cfg(copy.deepcopy(cfg), MODELS)
    samples, batch, cls, reg = decoded_loss_case(17)
    jsam = {k: jnp.asarray(v) for k, v in samples.items()}

    def j_fn(r):
        out = j_roi.rcnn_bbox_loss(jhead, jnp.asarray(cls), r, jsam,
                                   {"gt_bboxes": jnp.asarray(batch["gt_bboxes"])})
        return out["loss_bbox"], out

    (_, want), want_grad = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jnp.asarray(reg))
    reg_t = t(reg).requires_grad_(True)
    tsam = {k: t(v, torch.int64 if k in ("labels", "assigned") else None)
            for k, v in samples.items()}
    got = roi.rcnn_bbox_loss(phead, t(cls), reg_t, tsam,
                             {"gt_bboxes": t(batch["gt_bboxes"])})
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    got["loss_bbox"].backward()
    wg = np.asarray(want_grad)
    assert np.abs(wg).max() > 0
    np.testing.assert_allclose(reg_t.grad.numpy(), wg, rtol=1e-4,
                               atol=1e-4 * np.abs(wg).max())


# -- the standalone RPN and Fast R-CNN -----------------------------------------

@pytest.mark.slow
def test_rpn_only_predict_matches_jax():
    det, var, port = detector_pair(TINY_RPN)
    want = j_two_stage.rpn_only_predict(det, var, jnp.asarray(X),
                                        img_shapes=jnp.asarray(SHAPES),
                                        scale_factors=jnp.asarray(FACTORS))
    d, lab, v = detector_predict(port, U.nchw(X), t(SHAPES), t(FACTORS),
                                 device="cpu")
    assert d.shape == (B, 1000, 5) and not lab.any()
    np.testing.assert_array_equal(v.numpy(), np.asarray(want[2]))
    assert v.sum(1).min() > 100
    w = np.asarray(want[0])
    np.testing.assert_allclose(d.numpy(), w, rtol=1e-5, atol=1e-4)


def gt_batch(seed: int, k: int = 6):
    rng = np.random.RandomState(seed)
    h, w = HW
    gtb = np.zeros((B, k, 4), np.float32)
    for i in range(B):
        for j in range(k):
            bw, bh = rng.randint(6, 60), rng.randint(6, 40)
            x1, y1 = rng.randint(0, w - bw + 1), rng.randint(0, h - bh + 1)
            gtb[i, j] = (x1, y1, x1 + bw, y1 + bh)
    valid = np.arange(k)[None] < np.asarray([[3], [5]])
    labels = rng.randint(0, 20, (B, k)).astype(np.int32)
    return dict(gt_bboxes=gtb, gt_labels=labels, gt_valid=valid,
                img_shapes=SHAPES)


SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]


def head_outputs(seed: int, sizes, channels):
    rng = np.random.RandomState(seed)
    return [tuple(rng.randn(B, h, w, c).astype(np.float32) for h, w in sizes)
            for c in channels]


@pytest.mark.parametrize("loss_bbox", [None, dict(type="SmoothL1Loss",
                                                  beta=1.0 / 9.0)],
                         ids=["l1", "smooth_l1"])
def test_rpn_loss_with_allowed_border_matches_jax(loss_bbox):
    head_cfg = dict(TINY_RPN["rpn_head"], loss_bbox=loss_bbox)
    jhead = j_from_cfg(copy.deepcopy(head_cfg), J_MODELS)
    phead = build_from_cfg(copy.deepcopy(head_cfg), MODELS)
    scores, deltas = head_outputs(8, SIZES, (3, 12))
    batch = gt_batch(8)
    key = jax.random.PRNGKey(4)
    tc = dict(allowed_border=0)
    want = jax.jit(lambda s_, d_, b_, k_: j_rpn.rpn_loss(
        jhead, s_, d_, b_, train_cfg=tc, rng_key=k_))(
            tuple(map(jnp.asarray, scores)), tuple(map(jnp.asarray, deltas)),
            U.jax_batch(batch), key)
    a = sum(h * w * 3 for h, w in SIZES)
    draws = t(jax.random.uniform(key, (B, a)))
    tb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    ts, td = [t(x) for x in scores], [t(x) for x in deltas]
    got = rpn_head.rpn_loss(phead, ts, td, tb, draws, train_cfg=tc)
    for k in ("loss_rpn_cls", "loss_rpn_bbox"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    # the filter takes out the anchors past the border, as JAX's does
    anchors = phead.anchors.flat_anchors(SIZES)
    inside = anchor_inside_flags(anchors, t(SHAPES), 0.0)
    ja = np.asarray(jhead.make_anchor_generator().flat_anchors(SIZES))
    j_inside = np.stack([(ja[:, 0] >= 0) & (ja[:, 1] >= 0)
                         & (ja[:, 2] < w) & (ja[:, 3] < h) for h, w in SHAPES])
    np.testing.assert_array_equal(inside.numpy(), j_inside)
    assert 0 < int(inside.sum()) < inside.numel()
    # and it moves the loss: without it, more anchors take part
    plain = rpn_head.rpn_loss(phead, ts, td, tb, draws)
    assert float(plain["loss_rpn_cls"]) != float(got["loss_rpn_cls"])


def test_rpn_and_fast_rcnn_entry_points():
    rpn = build_detector(copy.deepcopy(TINY_RPN))
    rpn.init_weights(torch.Generator().manual_seed(0))
    batch = {k: t(v, torch.int64 if k == "gt_labels" else None)
             for k, v in gt_batch(2).items()}
    from dsl_tpu_torch.models.detectors.single_stage import detector_loss
    total, logs = detector_loss(rpn, dict(batch, images=U.nchw(X)))
    assert set(logs) == {"loss_rpn_cls", "loss_rpn_bbox", "loss"}
    total.backward()
    d, lab, v = detector_predict(rpn.eval(), U.nchw(X), t(SHAPES), device="cpu")
    assert d.shape == (B, 1000, 5) and v.sum() > 100 and not lab.any()
    fast = build_detector(copy.deepcopy(TINY_FAST_RCNN))
    fast.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="FastRCNN"):
        detector_predict(fast.eval(), U.nchw(X), device="cpu")
    with pytest.raises(NotImplementedError, match="FastRCNN"):
        detector_loss(fast, dict(batch, images=U.nchw(X)))
    fd, _, fv = two_stage.fast_rcnn_predict(fast, U.nchw(X), d[..., :4], v,
                                            img_shapes=t(SHAPES))
    assert fd.shape == (B, 100, 5) and bool(torch.isfinite(fd).all())


def det_sets_close(got, want, tol=1e-4):
    """Per image, the valid rows of dets (B, N, 5) + labels as sets, sorted
    by (label, x1, y1): equal labels, values within ``tol`` plus 1e-5 of
    their magnitude."""
    (gd, gl, gv), (wd, wl, wv) = got, want
    np.testing.assert_array_equal(gv, wv)
    for i in range(gd.shape[0]):
        rows = []
        for d, lab in ((gd[i][gv[i]], gl[i][gv[i]]), (wd[i][wv[i]], wl[i][wv[i]])):
            order = np.lexsort((np.round(d[:, 1], 1), np.round(d[:, 0], 1), lab))
            rows.append((d[order], lab[order]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=1e-5, atol=tol)


@pytest.mark.slow
def test_fast_rcnn_predict_matches_jax():
    det, var, port = detector_pair(TINY_FAST_RCNN)
    rng = np.random.RandomState(31)
    p = 120
    props = np.concatenate([rng.uniform(0, 50, (B, p, 2)),
                            rng.uniform(52, 96, (B, p, 2))], -1).astype(np.float32)
    props[..., 3] = np.minimum(props[..., 3], 64)
    pvalid = rng.rand(B, p) > 0.1
    want = j_two_stage.fast_rcnn_predict(
        det, var, jnp.asarray(X), jnp.asarray(props), jnp.asarray(pvalid),
        img_shapes=jnp.asarray(SHAPES), scale_factors=jnp.asarray(FACTORS))
    got = two_stage.fast_rcnn_predict(port, U.nchw(X), t(props), t(pvalid),
                                      img_shapes=t(SHAPES),
                                      scale_factors=t(FACTORS))
    assert got[0].shape == (B, 100, 5) and got[2].sum(1).min() > 20
    det_sets_close([g.numpy() for g in got], [np.asarray(w) for w in want])


def test_load_proposals_through_flip_and_resize():
    from dsl_tpu.data.pipelines.loading import LoadProposals as JLoad
    from dsl_tpu.data.pipelines.transforms import RandomFlip as JFlip
    from dsl_tpu.data.pipelines.transforms import Resize as JResize
    from dsl_tpu_torch.data.pipelines.loading import LoadProposals
    from dsl_tpu_torch.data.pipelines.transforms import RandomFlip, Resize

    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    props = np.concatenate([rng.uniform(0, 40, (7, 2)), rng.uniform(45, 60, (7, 2)),
                            rng.rand(7, 1)], 1).astype(np.float32)
    base = dict(proposals=props, img=img, img_shape=img.shape,
                bbox_fields=["gt_bboxes"],
                gt_bboxes=np.asarray([[1, 2, 30, 40]], np.float32))
    j = JLoad(num_max_proposals=5)(copy.deepcopy(base))
    j = JResize(img_scale=(120, 80), keep_ratio=True)(j)
    j = JFlip(flip_ratio=1.0)(j)
    p = LoadProposals(num_max_proposals=5)(dict(copy.deepcopy(base),
                                                img=torch.from_numpy(img)))
    r = np.random.RandomState(0)
    p = Resize(img_scale=(120, 80), keep_ratio=True)(p, r)
    p = RandomFlip(flip_ratio=1.0)(p, r)
    assert p["bbox_fields"] == ["gt_bboxes", "proposals"]
    assert p["proposals"].shape == (5, 4) and p["flip"]
    np.testing.assert_array_equal(p["proposals"], j["proposals"])
    np.testing.assert_array_equal(p["gt_bboxes"], j["gt_bboxes"])
    np.testing.assert_array_equal(p["img"].numpy(), j["img"])
    empty = LoadProposals(num_max_proposals=5)(dict(
        proposals=np.zeros((0, 4), np.float32)))
    np.testing.assert_array_equal(empty["proposals"], np.zeros((1, 4)))
    with pytest.raises(AssertionError, match="proposals"):
        LoadProposals()(dict(proposals=np.zeros((3, 6), np.float32)))


def test_retina_smooth_l1_loss_matches_jax():
    head_cfg = dict(TINY_RETINANET["bbox_head"],
                    loss_bbox=dict(type="SmoothL1Loss", beta=0.11,
                                   loss_weight=1.0))
    jhead = j_from_cfg(copy.deepcopy(head_cfg), J_MODELS)
    phead = build_from_cfg(copy.deepcopy(head_cfg), MODELS)
    sizes = SIZES[1:] + [(1, 1)]
    cls, reg = head_outputs(6, sizes, (9 * 20, 9 * 4))
    batch = gt_batch(3)
    want = jax.jit(lambda c_, r_, b_: j_retina_loss(jhead, c_, r_, b_))(
        tuple(map(jnp.asarray, cls)), tuple(map(jnp.asarray, reg)),
        U.jax_batch(batch))
    tb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    got = retina_loss(phead, [t(c) for c in cls], [t(r) for r in reg], tb)
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
