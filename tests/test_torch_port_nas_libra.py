"""The port's Balanced L1 loss, RetinaSepBNHead and NASFCOSHead (with the
Libra, NAS-FPN and NAS-FCOS detectors they serve) against the JAX package.

Seeded numpy inputs through each JAX function and its port, f32:

- ``balanced_l1_loss`` on differences below, at and above ``beta`` (both
  branches), at ``beta`` 1.0 and 0.11, weighted, with ``avg_factor``: the
  loss within 1e-6 relative and the prediction's gradient within 1e-5 of
  its largest magnitude;
- RetinaNet's loss (Libra RetinaNet: ``[FPN, BFP]``, Balanced L1 at beta
  0.11) and the RoI head's (Libra Faster R-CNN) on the same head outputs,
  samples and GT: each loss within 1e-5 relative;
- RetinaSepBNHead on NAS-FPN (stack_times 2): the head outputs within 1e-5
  of their kind's largest magnitude;
- NASFCOSHead alone on two seeded levels: the outputs within 1e-5 of
  their kind's largest magnitude; the whole tiny NAS-FCOS at 128x192
  (``slow``, the JAX package's deformable ops compile for about 25 s)
  within 1e-4 (GroupNorm(32) towers: flax's one-pass variance, as
  FCOS's); its levels at strides 4-64 under points laid at 8-128 in both
  packages (the repo's config adapts C2-C5);
- Libra Faster R-CNN's step raising on ``CombinedSampler`` (the JAX
  package trains it as the random sampler), and running with
  ``RandomSampler``; a list neck on a cascade and the GRoIE gcb configs'
  ``roi_extractor='sum'`` refused by name;
- the weight bridge both ways on the two heads, an mmdet-layout ``.pth``
  of RetinaSepBNHead (its tied convs under every level) loaded, an mmdet
  NASFCOSHead's deformable-op bias refused naming the key;
- every config of ``configs/libra_rcnn`` and ``configs/nas_fcos`` built on
  the meta device, with the JAX package's parameter counts for four, and
  the config sweep over the eight directories of this slice: every
  config builds.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.core import losses as JL
from dsl_tpu.models.dense_heads.retina_head import retina_loss as j_retina_loss
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads.nasfcos_head import NASFCOSHead
from dsl_tpu_torch.models.dense_heads.retina_head import (
    RetinaSepBNHead, retina_loss)
from dsl_tpu_torch.models.detectors.single_stage import (
    detector_loss, empty_detector)
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_CASCADE_RCNN, TINY_LIBRA_FASTER, TINY_LIBRA_RETINANET, TINY_NASFCOS,
    TINY_NASFPN_RETINANET)
from test_torch_port_two_stage import (
    B, SIZES, X, detector_pair, gt_batch, roi_samples_case, t, torch_batch)

torch.set_num_threads(2)

REL = 1e-5
NASFCOS_REL = 1e-4
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {
    "libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py": 41753056,
    "libra_rcnn/libra_retinanet_r50_fpn_1x_coco.py": 38558772,
    "libra_rcnn/libra_fast_rcnn_r50_fpn_1x_coco.py": 41159121,
    "nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py": 30717958}
SLICE_DIRS = ("gcnet", "empirical_attention", "pafpn", "carafe", "libra_rcnn",
              "nas_fpn", "nas_fcos", "fpg")


@pytest.mark.parametrize("beta", [1.0, 0.11])
def test_balanced_l1_loss_matches_jax(beta):
    rng = np.random.RandomState(0)
    target = rng.randn(64, 4).astype(np.float32)
    diff = np.concatenate([rng.uniform(0, 3 * beta, (62, 4)),
                           np.full((1, 4), beta), np.zeros((1, 4))])
    pred = (target + np.where(rng.rand(64, 4) < 0.5, -1, 1) * diff
            ).astype(np.float32)
    weight = (rng.rand(64, 4) < 0.8).astype(np.float32)
    kw = dict(beta=beta, alpha=0.5, gamma=1.5, avg_factor=37.0)
    want, want_grad = U.jax_run(jax.value_and_grad(
        lambda p: JL.balanced_l1_loss(p, jnp.asarray(target),
                                      weight=jnp.asarray(weight), **kw)),
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = L.balanced_l1_loss(p, torch.from_numpy(target),
                             weight=torch.from_numpy(weight), **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=REL * float(np.abs(want_grad).max()))
    # both branches are taken
    assert (diff < beta).any() and (diff > beta).any()


_PAIRS: dict = {}


def pair(cfg: dict):
    key = repr(cfg)
    if key not in _PAIRS:
        _PAIRS[key] = detector_pair(cfg)
    return _PAIRS[key]


def test_retina_loss_with_balanced_l1_matches_jax():
    det, var, port = pair(TINY_LIBRA_RETINANET)
    outs = U.jax_run(lambda v, x: det.apply(v, x), var, jnp.asarray(X))
    batch = gt_batch(21)
    want = jax.jit(lambda o, b: j_retina_loss(det.bbox_head, *o, b))(
        outs, U.jax_batch(batch))
    got = retina_loss(port.bbox_head,
                      *[[t(x) for x in kind] for kind in outs],
                      torch_batch(batch))
    assert set(got) == set(want) == {"loss_cls", "loss_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   err_msg=k)


def test_roi_head_loss_with_balanced_l1_matches_jax():
    det, var, port = pair(TINY_LIBRA_FASTER)
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
    assert head.loss_bbox["type"] == "BalancedL1Loss"
    got = roi.roi_head_loss(head, head, [U.nchw(f) for f in feats], samples,
                            tb, (4, 8, 16, 32))
    assert set(got) == set(want) == {"loss_cls", "acc", "loss_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   err_msg=k)


def _head_outputs_match(cfg, tol: float, x=X):
    det, var, port = pair(cfg)
    want = U.jax_run(lambda v, x_: det.apply(v, x_, training=True), var,
                     jnp.asarray(x))
    with torch.no_grad():
        got = port(U.nchw(x), training=True)
    for g_kind, w_kind in zip(got, want):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        for g, w in zip(g_kind, w_kind):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=tol * top)
    return got


def test_retina_sepbn_head_on_nas_fpn_matches_jax():
    _, _, port = pair(TINY_NASFPN_RETINANET)
    head = port.bbox_head
    assert isinstance(head, RetinaSepBNHead)
    # one kernel per tower conv, under every level; a BN per (level, conv)
    assert head.cls_convs[0][1].conv is head.cls_convs[4][1].conv
    assert head.cls_convs[0][1].bn is not head.cls_convs[4][1].bn
    assert head.cls_convs[0][0].conv.bias is None
    got = _head_outputs_match(TINY_NASFPN_RETINANET, REL)
    assert len(got[0]) == 5


def test_nasfcos_head_matches_jax():
    """The head alone on two seeded levels (8x12 and 4x6, 32 wide): its
    outputs."""
    from dsl_tpu.models.dense_heads.nasfcos_head import (
        NASFCOSHead as JNASFCOSHead)
    from dsl_tpu_torch.utils.random_weights import fill_variables

    kw = {k: v for k, v in TINY_NASFCOS["bbox_head"].items() if k != "type"}
    kw["strides"] = [8, 16]
    rng = np.random.RandomState(14)
    levels = [rng.randn(B, h, w, 32).astype(np.float32)
              for h, w in ((8, 12), (4, 6))]
    jhead = JNASFCOSHead(**kw)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in levels])
    var = fill_variables(U._plain(shapes), 15)
    sd = flax_to_state_dict({col: {"bbox_head": var.get(col, {})}
                             for col in ("params", "batch_stats")})
    head = NASFCOSHead(**kw)
    head.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()})
    assert tuple(head.cls_convs[0].conv.conv_offset.weight.shape
                 ) == (27, 32, 3, 3)
    assert float(head.cls_convs[2].conv.conv_offset.weight.abs().max()) > 0
    want = U.jax_run(lambda v, fs: jhead.apply(v, fs, training=True), var,
                     [jnp.asarray(f) for f in levels])
    with torch.no_grad():
        got = head.eval()([U.nchw(f) for f in levels], training=True)
    for g_kind, w_kind in zip(got, want):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        for g, w in zip(g_kind, w_kind):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=REL * top)


def test_nasfcos_levels_are_jaxs():
    """NAS-FCOS's levels at strides 4-64 (its FPN resizes its outputs to
    C2-C4, the repo's config adapting C2-C5) under FCOS points at 8-128,
    in both packages alike."""
    det, var, port = pair(TINY_NASFCOS)
    want = jax.eval_shape(lambda v, x: det.apply(v, x,
                                                 method=det.extract_feat),
                          var, jnp.asarray(X))
    with torch.no_grad():
        got = port(U.nchw(X))
    sizes = [tuple(c.shape[1:3]) for c in got[0]]
    assert sizes == [tuple(c.shape[1:3]) for c in want]
    assert sizes[0] == (X.shape[1] // 4, X.shape[2] // 4)
    assert port.bbox_head.strides[0] == 8


@pytest.mark.slow
def test_nasfcos_head_outputs_match_jax():
    """The whole tiny NAS-FCOS at 128x192: its head outputs within 1e-4 of
    their kind's largest magnitude (about 25 s: the JAX package compiles
    each deformable op tap by tap). At 64x96 the top level is 1x2, and its
    GroupNorm over two values per group is ill-conditioned under flax's
    one-pass variance: there JAX's regression lies 4e-2 off an f64 run of
    the port, the port's f32 8e-5."""
    _head_outputs_match(TINY_NASFCOS, NASFCOS_REL,
                        U.images(3, B, (128, 192)))


def test_nasfcos_loss_trains_the_deformable_ops():
    _, _, port = pair(TINY_NASFCOS)
    det = copy.deepcopy(port).train()
    batch = torch_batch(gt_batch(5))
    batch.update(images=U.nchw(X), gt_ignore=torch.zeros((B, 0, 4)),
                 ignore_valid=torch.zeros((B, 0), dtype=torch.bool),
                 source_weight=torch.ones((B,)))
    total, log_vars = detector_loss(det, batch)
    total.backward()
    assert all(np.isfinite(float(v)) for v in log_vars.values())
    off = det.bbox_head.reg_convs[2].conv.conv_offset.weight
    assert float(off.grad.abs().sum()) > 0


def test_libra_faster_rcnn_samplers():
    """The config's CombinedSampler raises in training (the JAX package
    reads no sampler type but OHEM's and trains it as the random sampler);
    with ``RandomSampler`` set, the step's loss is finite."""
    _, _, port = pair(TINY_LIBRA_FASTER)
    batch = dict(torch_batch(gt_batch(6)), images=U.nchw(X),
                 img_shapes=torch.tensor([[64.0, 96.0]] * B))
    det = copy.deepcopy(port).train()
    with pytest.raises(NotImplementedError, match="CombinedSampler"):
        detector_loss(det, batch)
    det.train_cfg = dict(rcnn=dict(sampler=dict(
        type="RandomSampler", num=512, pos_fraction=0.25,
        add_gt_as_proposals=True)))
    total, log_vars = detector_loss(det, batch)
    total.backward()
    assert all(np.isfinite(float(v)) for v in log_vars.values())
    assert float(det.neck[0].lateral_convs[0].conv.weight.grad.abs().sum()) > 0


@pytest.mark.parametrize("what", ["cascade_list_neck", "groie_sum"])
def test_what_stays_refused(what):
    if what == "cascade_list_neck":
        from dsl_tpu.models import build_detector as j_build

        cfg = dict(TINY_CASCADE_RCNN,
                   neck=[TINY_CASCADE_RCNN["neck"],
                         dict(type="BFP", in_channels=32, num_levels=5)])
        with pytest.raises(NotImplementedError, match="list neck"):
            build_detector(copy.deepcopy(cfg))
        with pytest.raises(TypeError):
            j_build(copy.deepcopy(cfg))
        return
    for path in sorted(glob.glob("configs/groie/*gcb*.py")):
        with pytest.raises(NotImplementedError,
                           match="roi_extractor='sum'"), torch.device("meta"):
            build_detector(dict(Config.fromfile(path).model))


@pytest.mark.parametrize("cfg", [TINY_NASFPN_RETINANET, TINY_NASFCOS],
                         ids=["sepbn", "nasfcos"])
def test_bridge_round_trip_and_mmdet_names(cfg, tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights

    _, var, port = pair(cfg)
    sd = port.state_dict()
    want = (["bbox_head.cls_convs.3.1.conv.weight",
             "bbox_head.reg_convs.0.0.bn.running_var"]
            if cfg is TINY_NASFPN_RETINANET else
            ["bbox_head.cls_convs.0.conv.weight",
             "bbox_head.reg_convs.2.conv.conv_offset.bias",
             "bbox_head.cls_convs.3.gn.weight", "bbox_head.cls_convs.1.conv.bias",
             "neck.cell_c61.out_conv.weight", "neck.adapt_bn3.running_mean"])
    assert set(want) <= set(sd)
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        ref = dict(jax.tree_util.tree_leaves_with_path(var[col]))
        assert sorted(got, key=str) == sorted(ref, key=str)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v)
    again = flax_to_state_dict(back)
    assert set(again) == set(sd)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    path = tmp_path / "mmdet.pth"
    if cfg is TINY_NASFPN_RETINANET:
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   path)
        fresh = empty_detector(copy.deepcopy(cfg))
        load_weights(str(path), fresh)
        assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
        return
    key = "bbox_head.cls_convs.0.conv.bias"
    torch.save({"state_dict": dict(sd, **{key: torch.zeros(32)})}, path)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        load_weights(str(path), empty_detector(copy.deepcopy(cfg)))


BUILT = sorted(p[len("configs/"):] for d in ("libra_rcnn", "nas_fcos")
               for p in glob.glob(f"configs/{d}/*.py"))


@pytest.mark.parametrize("config", BUILT)
def test_the_libra_and_nas_fcos_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    if "libra" in config:
        assert type(det.neck[1]).__name__ == "BFP"
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


@pytest.mark.parametrize("root", SLICE_DIRS)
def test_the_sweep_builds_every_config_of_the_slice(root):
    from dsl_tpu_torch.tools.config_sweep import sweep

    total, built, refused = sweep(f"configs/{root}")
    assert total == built == len(glob.glob(f"configs/{root}/*.py")) \
        and not refused, refused
