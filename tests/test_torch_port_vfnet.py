"""The port's VarifocalNet against the JAX package.

Seeded numpy inputs through each JAX function and its port, f32:

- ``star_dcn_offset`` and its gradient (the partial detach at
  ``gradient_mul``): 1e-6 of the largest magnitude;
- ``atss_assign`` on anchors whose distances to a GT's centre tie at the
  k-th (every tied anchor a candidate), beside a padded GT and GTs that
  take no anchor: labels, assigned GTs equal, IoUs within 1e-6;
- ``varifocal_loss`` and its gradient, with and without ``iou_weighted``:
  1e-6;
- the VFNet head (DCNv2 on the towers' last conv, the two star convs) on
  seeded FPN levels, three levels: every output within 5e-4 of its kind's
  largest magnitude (the 32-wide GN towers, one channel per group: flax's
  one-pass variance leaves JAX 2.6e-4 off an f64 run of the port on the
  class logits, where the port's f32 run is within 1e-5 of it, which the
  test also checks); ``slow`` over all five levels of the tiny detector;
- ``vfnet_loss`` and its gradients with respect to the three outputs, on
  seeded outputs: 1e-5;
- ``vfnet_get_bboxes`` on seeded outputs with tied class scores: labels,
  valid equal, dets within 1e-4 of their magnitude;
- the detector through the entry points (``detector_predict``, the loss
  and its backward reaching the star convs and the offset convs);
- the weight bridge both ways and mmdet's names
  (``vfnet_reg_refine_dconv.weight``, ``vfnet_cls_dconv.weight``, the
  towers' ``conv.conv_offset``); an mmdet-keyed file loaded;
- an mmdet-keyed file without the towers' biases (mmdet's GN towers have
  none, the JAX package's do) refused, naming what it lacks;
- every config of ``configs/vfnet/`` built on the meta device, with the
  JAX package's parameter counts for four.
"""

import copy
import glob
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.core.assigners import atss_assign as j_atss
from dsl_tpu.core.losses import varifocal_loss as j_vfl
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.dense_heads import vfnet_head as jv
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.core.anchors import AnchorGenerator
from dsl_tpu_torch.core.assigners import atss_assign
from dsl_tpu_torch.core.losses import varifocal_loss
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads import vfnet_head as pv
from dsl_tpu_torch.models.detectors.single_stage import (
    detector_loss, detector_predict, empty_detector)
from dsl_tpu_torch.ops.deform_conv import DeformConv2dPack
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import TINY_VFNET

torch.set_num_threads(2)

HW = (64, 96)
B = 2
NC = 20
HEAD_REL = 5e-4
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"vfnet/vfnet_r50_fpn_mdconv_c3-c5_mstrain_2x_coco.py": 33764609,
           "vfnet/vfnet_r2_101_fpn_mdconv_c3-c5_mstrain_2x_coco.py": 55020198,
           "vfnet/vfnet_x101_32x4d_fpn_mdconv_c3-c5_mstrain_2x_coco.py": 55496194,
           "vfnet/vfnet_r50_fpn_1x_coco.py": 32893346}
STRIDES = [8, 16, 32]
SHAPES = [(HW[0] // s, HW[1] // s) for s in STRIDES]


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def test_star_dcn_offset_and_its_gradient_match_jax():
    rng = np.random.RandomState(0)
    pred = np.exp(rng.randn(B, 5, 7, 4)).astype(np.float32) * 16
    g = rng.randn(B, 5, 7, 18).astype(np.float32)

    def loss(p):
        out = jv.star_dcn_offset(p, 0.1, 16.0)
        return (out * g).sum(), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(pred))
    t = torch.tensor(pred.transpose(0, 3, 1, 2), requires_grad=True)
    got = pv.star_dcn_offset(t, 0.1, 16.0)
    got.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)))
    assert rel(got.permute(0, 2, 3, 1), want) < 1e-6
    # only the gradient_mul share passes the detach
    assert rel(t.grad.permute(0, 2, 3, 1), want_grad) < 1e-6


def _atss_case():
    gen = AnchorGenerator(strides=STRIDES, ratios=(1.0,), scales=(8.0,),
                          center_offset=0.0)
    anchors = gen.flat_anchors(SHAPES)
    per_level = [h * w for h, w in SHAPES]
    # centres at x = 12, 28 (between two stride-8 points: tied distances),
    # a box too small to take a positive, a padded slot
    gt = np.array([[[4., 4., 20., 36.], [12., 8., 44., 40.],
                    [60., 30., 61., 31.], [0., 0., 0., 0.]],
                   [[30., 10., 90., 60.], [2., 2., 50., 62.],
                    [40., 16., 56., 32.], [5., 5., 9., 9.]]], np.float32)
    labels = np.array([[3, 7, 1, 0], [2, 5, 9, 4]], np.int64)
    valid = np.array([[True, True, True, False], [True, True, True, True]])
    return anchors, per_level, gt, labels, valid


def test_atss_assign_matches_jax_with_ties():
    anchors, per_level, gt, labels, valid = _atss_case()
    # the first GT's centre is 4 px from two stride-8 points per row:
    # distances tie at the 9th nearest, so a level gives more than 9
    d = np.hypot((anchors[:, 0] + anchors[:, 2]).numpy() / 2 - 12.0,
                 (anchors[:, 1] + anchors[:, 3]).numpy() / 2 - 20.0)
    lvl0 = np.sort(d[:per_level[0]])
    assert lvl0[8] == lvl0[9]
    want = jax.jit(lambda a, g, l, v: j_atss(a, per_level, g, l, v, topk=9,
                                             num_classes=NC))(
        jnp.asarray(anchors.numpy()), jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(valid))
    got = atss_assign(anchors, per_level, torch.from_numpy(gt),
                      torch.from_numpy(labels), torch.from_numpy(valid),
                      topk=9, num_classes=NC)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-6)
    pos = got[0].numpy() < NC
    assert pos.sum() > 0 and not (got[1].numpy()[0] == 3).any()


@pytest.mark.parametrize("iou_weighted", [True, False])
def test_varifocal_loss_and_its_gradient_match_jax(iou_weighted):
    rng = np.random.RandomState(1)
    logits = (2 * rng.randn(B, 30, NC)).astype(np.float32)
    targets = np.where(rng.rand(B, 30, NC) < 0.1, rng.rand(B, 30, NC), 0.0
                       ).astype(np.float32)
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda x: j_vfl(x, jnp.asarray(targets), iou_weighted=iou_weighted,
                        avg_factor=7.0)))(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    got = varifocal_loss(t, torch.from_numpy(targets),
                         iou_weighted=iou_weighted, avg_factor=7.0)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert rel(t.grad, want_grad) < 1e-6


def _head_pair(levels: int):
    """The JAX VFNet head of the tiny detector over ``levels`` levels, its
    seeded variables and the port's head with them."""
    cfg = dict(TINY_VFNET["bbox_head"], strides=[8, 16, 32, 64, 128][:levels])
    kw = {k: v for k, v in cfg.items() if k != "type"}
    jhead = jv.VFNetHead(**kw)
    feats = tuple(jnp.zeros((1, -(-HW[0] // s), -(-HW[1] // s), 32))
                  for s in kw["strides"])
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), feats)
    var = fill_variables(U._plain(shapes), 3)
    sd = flax_to_state_dict({"params": {"bbox_head": var["params"]}})
    port = pv.VFNetHead(**kw)
    port.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()})
    return jhead, var, port.eval(), kw["strides"]


@pytest.mark.parametrize("levels", [3, pytest.param(5, marks=pytest.mark.slow)])
def test_head_outputs_match_jax(levels):
    jhead, var, port, strides = _head_pair(levels)
    assert isinstance(port.cls_convs[1].conv, DeformConv2dPack)
    rng = np.random.RandomState(4)
    feats = [rng.randn(B, -(-HW[0] // s), -(-HW[1] // s), 32).astype(np.float32)
             for s in strides]
    want = U.jax_run(lambda v, f: jhead.apply(v, f), var,
                     tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        got = port([U.nchw(f) for f in feats])
        exact = copy.deepcopy(port).double()(
            [U.nchw(f).double() for f in feats])
    for g_kind, w_kind, e_kind in zip(got, want, exact):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        for g, w, e in zip(g_kind, w_kind, e_kind):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=HEAD_REL * top)
            np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=0,
                                       atol=1e-5 * top)


def _outputs(seed: int):
    """Seeded head outputs (NHWC per level): class logits, positive
    initial and refined (l, t, r, b) at a few strides."""
    rng = np.random.RandomState(seed)
    cls = [(rng.randn(B, h, w, NC) - 1).astype(np.float32) for h, w in SHAPES]
    ini = [(np.exp(0.5 * rng.randn(B, h, w, 4)) * 2 * s).astype(np.float32)
           for (h, w), s in zip(SHAPES, STRIDES)]
    ref = [(np.exp(0.3 * rng.randn(B, h, w, 4)) * a).astype(np.float32)
           for (h, w), a in zip(SHAPES, ini)]
    return cls, ini, ref


def test_vfnet_loss_and_its_gradients_match_jax():
    _, _, gt, labels, valid = _atss_case()
    head_kw = dict(num_classes=NC, in_channels=32, feat_channels=32,
                   strides=STRIDES)
    jhead, head = jv.VFNetHead(**head_kw), pv.VFNetHead(**head_kw)
    cls, ini, ref = _outputs(5)
    batch = dict(gt_bboxes=gt, gt_labels=labels, gt_valid=valid)

    def loss(c, i, r):
        out = jv.vfnet_loss(jhead, c, i, r,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        return sum(out.values()), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *([jnp.asarray(a) for a in x] for x in (cls, ini, ref)))
    ts = [[torch.tensor(a, requires_grad=True) for a in x]
          for x in (cls, ini, ref)]
    got = pv.vfnet_loss(head, *ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert sorted(got) == sorted(want) == ["loss_bbox", "loss_bbox_rf",
                                           "loss_cls"]
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    sum(got.values()).backward()
    for t_kind, w_kind in zip(ts, want_grads):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        for t, w in zip(t_kind, w_kind):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5 * top)


def test_vfnet_get_bboxes_matches_jax_with_tied_scores():
    head_kw = dict(num_classes=NC, in_channels=32, feat_channels=32,
                   strides=STRIDES)
    jhead, head = jv.VFNetHead(**head_kw), pv.VFNetHead(**head_kw)
    cls, _, ref = _outputs(6)
    cls[0][:, :, :3, :] = cls[0][:, :, 3:6, :]     # ties across points
    shapes = np.array([[60.0, 90.0], [64.0, 80.0]], np.float32)
    scale = np.array([[1.5, 1.5, 1.5, 1.5], [2.0, 2.0, 2.0, 2.0]], np.float32)
    kw = dict(nms_pre=40, score_thr=0.05, iou_threshold=0.6, max_per_img=50)
    want = jax.jit(lambda c, r, s, f: jv.vfnet_get_bboxes(
        jhead, c, None, r, img_shapes=s, scale_factors=f, **kw))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in ref],
        jnp.asarray(shapes), jnp.asarray(scale))
    got = pv.vfnet_get_bboxes(head, [torch.from_numpy(c) for c in cls], None,
                              [torch.from_numpy(r) for r in ref],
                              img_shapes=torch.from_numpy(shapes),
                              scale_factors=torch.from_numpy(scale), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() > 20
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    dets = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy(), dets, rtol=0,
                               atol=1e-4 * np.abs(dets).max())


_PAIRS: dict = {}


def pair():
    if not _PAIRS:
        det = j_build(copy.deepcopy(TINY_VFNET))
        shapes = jax.eval_shape(
            lambda r, x: init_detector_variables(det, r, x),
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
        var = {k: U._plain(v) for k, v in fill_variables(dict(shapes)).items()}
        port = empty_detector(copy.deepcopy(TINY_VFNET))
        port.load_state_dict(flax_to_state_dict(var))
        _PAIRS.update(det=det, var=var, port=port.eval())
    return _PAIRS["det"], _PAIRS["var"], _PAIRS["port"]


def test_the_entry_points_run_and_train_the_deformable_parts():
    _, _, port = pair()
    det = copy.deepcopy(port)
    x = U.nchw(U.images(7, B, HW))
    dets, labels, valid = detector_predict(
        det, x, img_shapes=torch.tensor([list(HW)] * B, dtype=torch.float32),
        device="cpu")
    assert tuple(dets.shape) == (B, 100, 5) and bool(torch.isfinite(dets).all())
    assert int(valid.sum(1).min()) > 0
    _, _, gt, labels, valid = _atss_case()
    batch = dict(images=x, gt_bboxes=torch.from_numpy(gt),
                 gt_labels=torch.from_numpy(labels),
                 gt_valid=torch.from_numpy(valid))
    total, log_vars = detector_loss(det.train(), batch)
    total.backward()
    assert {"loss_cls", "loss_bbox", "loss_bbox_rf", "loss"} == set(log_vars)
    assert all(np.isfinite(float(v)) for v in log_vars.values())
    head = det.bbox_head
    for p in (head.vfnet_cls_dconv.weight, head.vfnet_reg_refine_dconv.weight,
              head.cls_convs[1].conv.conv_offset.weight,
              det.backbone.layer4[0].conv2.conv_offset.weight):
        assert float(p.grad.abs().sum()) > 0


def test_bridge_round_trip_and_mmdet_names(tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights

    _, var, port = pair()
    sd = port.state_dict()
    assert {"bbox_head.vfnet_reg_refine_dconv.weight",
            "bbox_head.vfnet_cls_dconv.weight",
            "bbox_head.vfnet_reg_conv.conv.weight",
            "bbox_head.vfnet_reg_conv.gn.bias", "bbox_head.scales_refine.4.scale",
            "bbox_head.cls_convs.1.conv.weight",
            "bbox_head.cls_convs.1.conv.bias",
            "bbox_head.reg_convs.1.conv.conv_offset.weight"} <= set(sd)
    assert tuple(sd["bbox_head.reg_convs.1.conv.conv_offset.weight"].shape) \
        == (27, 32, 3, 3)
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        ref = dict(jax.tree_util.tree_leaves_with_path(var[col]))
        assert sorted(got, key=str) == sorted(ref, key=str)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v)
    again = flax_to_state_dict(back)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = empty_detector(copy.deepcopy(TINY_VFNET))
    load_weights(str(path), fresh)
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


def test_an_mmdet_file_without_the_towers_biases_raises(tmp_path):
    """A difference by design: the JAX package's VFNet towers (and
    ``vfnet_reg_conv``) carry biases, mmdet's GN towers have none, so an
    mmdet VFNet checkpoint lacks keys of the port's detector and its load
    raises naming them (the port keeps the JAX package's function)."""
    from dsl_tpu_torch.utils.checkpoint import load_weights

    _, _, port = pair()
    sd = {k: v for k, v in port.state_dict().items()
          if not re.fullmatch(r"bbox_head\.(cls_convs|reg_convs)\.\d+\.conv\.bias"
                              r"|bbox_head\.vfnet_reg_conv\.conv\.bias", k)}
    assert len(sd) == len(port.state_dict()) - 5
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError, match="lacks 5 keys"):
        load_weights(str(path), empty_detector(copy.deepcopy(TINY_VFNET)))


BUILT = sorted(p[len("configs/"):] for p in glob.glob("configs/vfnet/*.py"))


@pytest.mark.parametrize("config", BUILT)
def test_the_vfnet_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    assert type(det).__name__ == "VFNet"
    assert isinstance(det.bbox_head, pv.VFNetHead)
    if "mdconv" in config:
        assert any(isinstance(m, DeformConv2dPack)
                   for m in det.backbone.modules())
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]
