"""The port's deformable convolution, deformable RoI pooling and the parts
that run them against the JAX package.

Seeded numpy inputs through each JAX function and its port, f32 (the
tiny configs of ``synthetic_data``: a ResNet-50 at a quarter width with
DCNv2 in c3-c5 and 4 offset groups, the dpool / mdpool packs at 64 wide,
FCOS on a caffe ResNet with DCN and DCNv2 on its towers' last conv):

- ``deform_conv2d``: v1 at dilation 2, v2 at stride 2, a grouped kernel
  (4 groups) and 4 offset groups, each at zero offsets (every tap on an
  integer position, the map's first and last rows and columns exactly on
  the clip's bounds, where the JAX clip's gradient is 0.5) and at seeded
  offsets that put samples in (-1, 0), in (H-1, H) and beyond the map:
  the output and the gradients of the input, the offsets, the mask and
  the kernel within 1e-5 of each one's largest magnitude (one JAX
  compile per case: 4 offset groups take about 27 s, so that case is
  ``slow``);
- the border rule: a sample in (-1, 0) reads row 0 at full weight (mmcv's
  kernel would weigh it by the distance), one at -1 or H reads nothing,
  the same in both packages;
- ``sample_points`` (outputs and gradients, 1e-5) and ``deform_roi_align``
  plain and modulated (a mask multiplied after it), with RoIs over the
  map's edges and offsets that move samples off it: outputs and the
  gradients of the features, the offsets and the mask within 1e-5;
- a DCNv2 bottleneck (pytorch style, strided, 2 offset groups) and the
  backbones' levels with DCN: ResNet (pytorch and caffe style), ResNeXt,
  RegNet and Res2Net: 1e-5 of the largest magnitude (a whole backbone's
  JAX compile takes 10-60 s: ``slow``);
- FCOS with ``dcn_on_last_conv``: the head outputs within 1e-4 of their
  kind's largest magnitude (the 32-wide GN towers: flax's one-pass
  variance, both packages 5e-5 off an f64 run on the centerness;
  ``slow``, about 30 s);
- the dpool and mdpool RoI heads: the deformably pooled features and the
  box head's outputs within 1e-5, and the pack's gradient alive in a
  two-stage loss through the entry point;
- the weight bridge both ways, mmdet's ``conv2.conv_offset`` and
  ``offset_fc`` / ``mask_fc`` names (an mmdet file keeps one pack per
  level: equal ones load, differing ones raise naming the keys);
- what stays refused by name in both packages (a plugin at a position
  the JAX package never runs, DCN on a
  BasicBlock, RepPoints);
- every config of ``configs/dcn/`` (and the DCN FCOS and RegNet ones)
  built on the meta device, with the JAX package's parameter counts.
"""

import copy
import functools
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.models.detectors.two_stage import _pack_ctx
from dsl_tpu.models.roi_heads.standard_roi_head import _extract_for_head
from dsl_tpu.ops import deform_conv as jdc
from dsl_tpu.ops import roi_align as jra
from dsl_tpu.registry import MODELS as J_MODELS
from dsl_tpu.registry import build_from_cfg as j_build_from_cfg
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.single_stage import empty_detector
from dsl_tpu_torch.models.roi_heads.standard_roi_head import extract_roi_feats
from dsl_tpu_torch.ops import deform_conv as dc
from dsl_tpu_torch.ops import roi_align as ra
from dsl_tpu_torch.registry import MODELS, build_from_cfg
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_DCN_FASTER, TINY_DPOOL_FASTER, TINY_FCOS_DCN, TINY_MDPOOL_FASTER)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
REL = 1e-5
FCOS_REL = 1e-4
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {
    "dcn/faster_rcnn_r50_fpn_mdconv_c3-c5_group4_1x_coco.py": 45238108,
    "dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py": 68645491,
    "dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py": 55749186,
    "dcn/faster_rcnn_x101_32x4d_fpn_dconv_c3-c5_1x_coco.py": 62945532,
    "dcn/cascade_mask_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py": 72618888,
    "fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_fpn_gn-head_dcn_1x_coco.py": 32421840,
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py": 36980269}


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def nchw(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 3, 1, 2)


def hwio(w) -> np.ndarray:
    """A torch OIHW kernel in flax's HWIO."""
    return np.asarray(w).transpose(2, 3, 1, 0)


# (name, cin, cout, conv groups, deform groups, stride, dilation, v2)
DCN_CASES = [("v1_dilation2", 8, 6, 1, 1, 1, 2, False),
             ("v2_stride2", 8, 6, 1, 1, 2, 1, True),
             ("grouped", 8, 8, 4, 1, 1, 1, True),
             pytest.param(("dg4", 8, 6, 1, 4, 1, 1, True),
                          marks=pytest.mark.slow)]


def _dcn_inputs(case, zero: bool, seed: int = 0):
    _, cin, cout, groups, dg, stride, _, _ = case
    rng = np.random.RandomState(seed)
    h, w = 7, 9
    oh, ow = -(-h // stride), -(-w // stride)
    x = rng.randn(B, cin, h, w).astype(np.float32)
    off = (np.zeros((B, dg * 18, oh, ow)) if zero
           else 2.5 * rng.randn(B, dg * 18, oh, ow)).astype(np.float32)
    mask = rng.rand(B, dg * 9, oh, ow).astype(np.float32)
    wt = rng.randn(cout, cin // groups, 3, 3).astype(np.float32)
    g = rng.randn(B, cout, oh, ow).astype(np.float32)
    return x, off, mask, wt, g


def _sample_rows(case, off) -> np.ndarray:
    """Every tap's sample row (y) of offsets ``off``, as both packages
    place them."""
    _, _, _, _, dg, stride, dil, _ = case
    o = off.reshape(B, dg, 9, 2, *off.shape[2:])
    ti = (np.arange(3).repeat(3) * dil - dil)[None, None, :, None, None]
    gy = (np.arange(off.shape[2]) * stride)[None, None, None, :, None]
    return gy + ti + o[:, :, :, 0]


@functools.lru_cache(maxsize=None)
def _jax_dcn(case):
    """JAX's deform_conv2d of ``case`` and its gradients, compiled once for
    both offset fills."""
    _, _, _, _, dg, stride, dil, v2 = case

    def loss(x_, off_, mask_, wt_, g_):
        out = jdc.deform_conv2d(x_, off_, wt_, mask=mask_ if v2 else None,
                                dilation=dil, stride=stride, deform_groups=dg)
        return (out * g_).sum(), out

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                      has_aux=True))


@pytest.mark.parametrize("zero", [True, False], ids=["zero_offsets", "seeded"])
@pytest.mark.parametrize("case", DCN_CASES, ids=lambda c: c[0])
def test_deform_conv2d_matches_jax(case, zero):
    _, _, _, _, dg, stride, dil, v2 = case
    x, off, mask, wt, g = _dcn_inputs(case, zero)
    if not zero:
        ys = _sample_rows(case, off)
        assert ((ys > -1) & (ys < 0)).any() and ((ys > 6) & (ys < 7)).any()
        assert (ys >= 7).any() and (ys <= -1).any()
    (_, j_out), j_grads = _jax_dcn(case)(
        *(jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (x, off, mask)),
        jnp.asarray(hwio(wt)), jnp.asarray(g.transpose(0, 2, 3, 1)))
    t = [torch.tensor(a, requires_grad=True) for a in (x, off, mask, wt)]
    out = dc.deform_conv2d(t[0], t[1], t[3], mask=t[2] if v2 else None,
                           stride=stride, dilation=dil, deform_groups=dg)
    out.backward(torch.from_numpy(g))
    assert rel(out, nchw(j_out)) < REL
    want = [nchw(j_grads[0]), nchw(j_grads[1]), nchw(j_grads[2]),
            np.asarray(j_grads[3]).transpose(3, 2, 0, 1)]
    for i, (tg, wg) in enumerate(zip(t, want)):
        if i == 2 and not v2:
            assert tg.grad is None
            continue
        assert rel(tg.grad, wg) < REL, i


def test_the_clips_gradient_at_the_bounds_is_jaxs():
    """``jnp.clip``'s gradient is 0.5 at each bound under the installed JAX
    (``torch.clamp``'s would be 1); the port's sampling rule gives the
    offsets JAX's gradient on a map's first row, where zero offsets put a
    tap exactly on the bound."""
    g = jax.grad(lambda v: jnp.clip(v, 0.0, 5.0).sum())(jnp.array([0.0, 5.0]))
    np.testing.assert_array_equal(np.asarray(g), [0.5, 0.5])
    ys = torch.zeros((), requires_grad=True)
    _, wts = dc._corners(ys, torch.zeros(()), 4, 4)
    # d(weight of the lower neighbour) / dy: the clip's 0.5
    assert torch.autograd.grad(wts[2], ys)[0].item() == 0.5


def test_the_border_rule_is_jaxs_not_mmcvs():
    """A difference by design: a sample counts where -1 < y < H (strict) and
    then reads the map with y clipped to [0, H-1], so y = -0.5 reads row 0
    at full weight (mmcv's kernel weighs it by 0.5) and y = -1 or H reads
    nothing, in both packages."""
    x = np.arange(2 * 5 * 6, dtype=np.float32).reshape(1, 2, 5, 6)
    ys = np.array([-0.5, 4.5, -1.0, 5.0, -0.999], np.float32)[None, None, None]
    xs = np.full_like(ys, 2.0)
    got = dc.sample_points(torch.from_numpy(x), torch.from_numpy(ys),
                           torch.from_numpy(xs))[0, 0, 0]
    want = np.asarray(jax.jit(jdc.sample_points)(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(ys),
        jnp.asarray(xs)))[0, 0, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [
        x[0, :, 0, 2], x[0, :, 4, 2], [0, 0], [0, 0], x[0, :, 0, 2]])


def test_sample_points_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(B, 6, 7, 9).astype(np.float32)
    ys = (rng.rand(B, 5, 4, 3) * 10 - 2).astype(np.float32)
    xs = (rng.rand(B, 5, 4, 3) * 12 - 2).astype(np.float32)
    g = rng.randn(B, 5, 4, 3, 6).astype(np.float32)

    def loss(x_, ys_, xs_):
        out = jdc.sample_points(x_, ys_, xs_)
        return (out * g).sum(), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(ys), jnp.asarray(xs))
    t = [torch.tensor(a, requires_grad=True) for a in (x, ys, xs)]
    out = dc.sample_points(*t)
    out.backward(torch.from_numpy(g))
    assert rel(out, j_out) < REL
    assert rel(t[0].grad, nchw(j_grads[0])) < REL
    assert rel(t[1].grad, j_grads[1]) < REL
    assert rel(t[2].grad, j_grads[2]) < REL


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "modulated"])
def test_deform_roi_align_matches_jax(modulated):
    """The mask, where there is one, multiplies the pooled features (the
    pack's order)."""
    rng = np.random.RandomState(4)
    feats = rng.randn(B, 5, 12, 16).astype(np.float32)
    n = 7
    xy = rng.rand(n, 2) * np.array([64.0, 48.0]) - 8.0
    wh = rng.rand(n, 2) * np.array([40.0, 30.0]) + 1.0
    rois = np.concatenate([rng.randint(0, B, (n, 1)), xy, xy + wh],
                          axis=1).astype(np.float32)
    offsets = (1.5 * rng.randn(n, 7, 7, 2)).astype(np.float32)
    mask = rng.rand(n, 7, 7, 1).astype(np.float32)
    valid = np.array([True] * (n - 1) + [False])
    g = rng.randn(n, 7, 7, 5).astype(np.float32)

    def loss(f, off, m):
        out = jra.deform_roi_align(f, jnp.asarray(rois), off, out_size=(7, 7),
                                   spatial_scale=0.25, sampling_ratio=2,
                                   gamma=0.1, valid=jnp.asarray(valid))
        out = out * m if modulated else out
        return (out * g).sum(), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(feats.transpose(0, 2, 3, 1)), jnp.asarray(offsets),
        jnp.asarray(mask))
    t = [torch.tensor(a, requires_grad=True) for a in (feats, offsets, mask)]
    out = ra.deform_roi_align(t[0], torch.from_numpy(rois), t[1], (7, 7), 0.25,
                              2, 0.1, torch.from_numpy(valid))
    if modulated:
        out = out * t[2].permute(0, 3, 1, 2)
    out.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)))
    assert rel(out, nchw(j_out)) < REL
    assert rel(t[0].grad, nchw(j_grads[0])) < REL
    assert rel(t[1].grad, j_grads[1]) < REL
    if modulated:
        assert rel(t[2].grad, j_grads[2]) < REL


_PAIRS: dict = {}


def pair(cfg: dict):
    """The JAX detector of ``cfg``, its seeded variables and the port's
    detector with them (eval mode), traced once."""
    key = repr(cfg)
    if key not in _PAIRS:
        det = j_build(copy.deepcopy(cfg))
        shapes = jax.eval_shape(
            lambda r, x: init_detector_variables(det, r, x),
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
        var = {k: U._plain(v) for k, v in fill_variables(dict(shapes)).items()}
        port = empty_detector(copy.deepcopy(cfg))
        port.load_state_dict(flax_to_state_dict(var))
        _PAIRS[key] = det, var, port.eval()
    return _PAIRS[key]


_TINY_BACKBONE = TINY_DCN_FASTER["backbone"]
BACKBONES = {
    "resnet_pytorch": dict(_TINY_BACKBONE, stage_with_dcn=(False, True, True,
                                                           True),
                           dcn=dict(type="DCNv2", deform_groups=4)),
    "resnet_caffe": dict(TINY_FCOS_DCN["backbone"],
                         stage_with_dcn=(False, True, True, True)),
    "resnext": dict(_TINY_BACKBONE, type="ResNeXt", groups=4, base_width=4,
                    dcn=dict(type="DCN")),
    "regnet": dict(type="RegNet", arch="regnetx_400mf", out_indices=(0, 1, 2, 3),
                   dcn=dict(type="DCNv2"),
                   stage_with_dcn=(False, True, True, True)),
    "res2net": dict(type="Res2Net", depth=50, scales=4, base_width=26,
                    base_channels=16, out_indices=(0, 1, 2, 3),
                    dcn=dict(type="DCNv2"),
                    stage_with_dcn=(False, True, False, True))}


def test_dcn_bottleneck_matches_jax():
    """A strided DCNv2 bottleneck with 2 offset groups (pytorch style: the
    stride on the deformable conv), its offset conv seeded non-zero."""
    from dsl_tpu.models.backbones.resnet import Bottleneck as JBottleneck
    from dsl_tpu_torch.models.backbones.resnet import Bottleneck

    dcn = dict(type="DCNv2", deform_groups=2)
    jmod = JBottleneck(planes=8, stride=2, dcn=dcn)
    x = np.random.RandomState(11).randn(B, 12, 15, 32).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    var = fill_variables(U._plain(shapes), 12)
    assert float(np.abs(var["params"]["conv2_offset"]["kernel"]).max()) > 0
    sd = flax_to_state_dict({col: {"backbone": {"layer1_0": var.get(col, {})}}
                             for col in ("params", "batch_stats")})
    port = Bottleneck(32, 8, stride=2, dcn=dcn)
    port.load_state_dict({k[len("backbone.layer1.0."):]: v
                          for k, v in sd.items()})
    want = U.jax_run(jmod.apply, var, jnp.asarray(x))
    with torch.no_grad():
        got = port(U.nchw(x))
    assert isinstance(port.conv2, dc.DeformConv2dPack)
    assert rel(got, nchw(want)) < REL


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_dcn_backbone_levels_match_jax(name):
    cfg = BACKBONES[name]
    jmod = j_build_from_cfg(copy.deepcopy(cfg), J_MODELS)
    x = U.images(6, 1, HW)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    var = fill_variables(U._plain(shapes), 7)
    sd = flax_to_state_dict({col: {"backbone": var.get(col, {})}
                             for col in ("params", "batch_stats")})
    port = build_from_cfg(copy.deepcopy(cfg), MODELS)
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    assert any(isinstance(m, dc.DeformConv2dPack) for m in port.modules())
    want = U.jax_run(jmod.apply, var, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(U.nchw(x))
    assert len(got) == len(want) == 4
    for gl, wl in zip(got, want):
        assert rel(gl, nchw(wl)) < REL


@pytest.mark.slow
def test_fcos_head_with_dcn_on_last_conv_matches_jax():
    det, var, port = pair(TINY_FCOS_DCN)
    assert isinstance(port.bbox_head.cls_convs[1].conv, dc.DeformConv2dPack)
    x = U.images(8, B, HW)
    want = U.jax_run(lambda v, x_: det.apply(v, x_, training=True), var,
                     jnp.asarray(x))
    with torch.no_grad():
        got = port(U.nchw(x), training=True)
    for g_kind, w_kind in zip(got, want):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        for g, w in zip(g_kind, w_kind):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=FCOS_REL * top)


def _roi_inputs(seed: int):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, 32, HW[0] // s, HW[1] // s).astype(np.float32)
             for s in (4, 8, 16, 32, 64)]
    n = 24
    xy = rng.rand(n, 2) * np.array([96.0, 64.0]) - 10.0
    wh = np.exp(rng.rand(n, 2) * 4.5)
    rois = np.concatenate([rng.randint(0, B, (n, 1)), xy, xy + wh],
                          axis=1).astype(np.float32)
    valid = rng.rand(n) > 0.1
    return feats, rois, valid


@pytest.mark.parametrize("cfg", [TINY_DPOOL_FASTER, TINY_MDPOOL_FASTER],
                         ids=["dpool", "mdpool"])
def test_deformable_roi_head_matches_jax(cfg):
    det, var, port = pair(cfg)
    feats, rois, valid = _roi_inputs(9)
    strides = (4, 8, 16, 32)

    def run(v, fs, r, ok):
        rf = _extract_for_head(det.bbox_head, fs, r, ok, strides,
                               pack=_pack_ctx(det, v))
        return rf, det.apply(v, rf, method=det.roi_forward)

    want_rf, (want_cls, want_reg) = U.jax_run(
        run, var, [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats],
        jnp.asarray(rois), jnp.asarray(valid))
    pk = port.roi_pool_pack
    with torch.no_grad():
        rf = extract_roi_feats([torch.from_numpy(f) for f in feats],
                               torch.from_numpy(rois), torch.from_numpy(valid),
                               strides, 7, True,
                               (lambda r: port(r, stage="pack"), pk))
        cls, reg = port(rf, stage="roi")
        offsets, _ = port(extract_roi_feats(
            [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
            torch.from_numpy(valid), strides), stage="pack")
    assert float(offsets.abs().max()) > 0.5      # the samples do move
    assert (pk.mask_fc is not None) == (cfg is TINY_MDPOOL_FASTER)
    assert rel(rf, nchw(want_rf)) < REL
    assert rel(cls, want_cls) < REL and rel(reg, want_reg) < REL


def test_the_pack_trains_through_the_two_stage_loss():
    """A dpool Faster R-CNN's loss through the entry point: the offsets'
    FCs get a gradient (zero at the start, the last of them), the bbox
    head's loss finite."""
    from dsl_tpu_torch.models.detectors.single_stage import detector_loss

    det = build_detector(copy.deepcopy(TINY_MDPOOL_FASTER))
    det.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(10)
    batch = dict(images=torch.from_numpy(rng.randn(B, 3, *HW).astype(np.float32)),
                 gt_bboxes=torch.tensor([[[8., 6., 50., 40.], [30., 20., 90., 60.]]] * B),
                 gt_labels=torch.tensor([[1, 3]] * B),
                 gt_valid=torch.tensor([[True, True]] * B),
                 img_shapes=torch.tensor([list(HW)] * B, dtype=torch.float32))
    total, log_vars = detector_loss(det, batch)
    total.backward()
    assert all(np.isfinite(float(v)) for v in log_vars.values())
    last = det.roi_pool_pack.offset_fc[4]
    assert float(last.weight.detach().abs().sum()) == 0.0
    assert float(last.weight.grad.abs().sum()) > 0.0
    assert float(det.roi_pool_pack.mask_fc[2].weight.grad.abs().sum()) > 0.0


@pytest.mark.parametrize("cfg", [TINY_DCN_FASTER, TINY_MDPOOL_FASTER],
                         ids=["dcn_backbone", "mdpool"])
def test_bridge_round_trip_and_mmdet_names(cfg, tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights

    _, var, port = pair(cfg)
    sd = port.state_dict()
    want = (["backbone.layer4.0.conv2.weight",
             "backbone.layer4.0.conv2.conv_offset.weight",
             "backbone.layer4.2.conv2.conv_offset.bias"]
            if cfg is TINY_DCN_FASTER else
            ["roi_head.roi_pool_pack.offset_fc.0.weight",
             "roi_head.roi_pool_pack.offset_fc.4.bias",
             "roi_head.roi_pool_pack.mask_fc.2.weight"])
    assert set(want) <= set(sd)
    if cfg is TINY_DCN_FASTER:
        # DCNv2 with 2 offset groups: 2 x 27 offset and mask channels
        assert tuple(sd[want[1]].shape) == (54, 128, 3, 3)
        assert "backbone.layer3.0.conv2.conv_offset.weight" not in sd
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        ref = dict(jax.tree_util.tree_leaves_with_path(var[col]))
        assert sorted(got, key=str) == sorted(ref, key=str)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v)
    again = flax_to_state_dict(back)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    # mmdet's names: one pack per level of the RoI extractor
    mmdet = {}
    for k, v in sd.items():
        if k.startswith("roi_head.roi_pool_pack."):
            for lvl in range(4):
                mmdet[k.replace("roi_head.roi_pool_pack.",
                                f"roi_head.bbox_roi_extractor.roi_layers.{lvl}.")] = v
        else:
            mmdet[k] = v
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in mmdet.items()}},
               path)
    fresh = empty_detector(copy.deepcopy(cfg))
    load_weights(str(path), fresh)
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    if cfg is TINY_MDPOOL_FASTER:
        key = "roi_head.bbox_roi_extractor.roi_layers.2.offset_fc.0.weight"
        mmdet[key] = mmdet[key] + 1.0
        torch.save({"state_dict": mmdet}, path)
        with pytest.raises(KeyError, match="roi_layers.2.offset_fc.0.weight"):
            load_weights(str(path), empty_detector(copy.deepcopy(cfg)))


@pytest.mark.parametrize("what", ["plugins", "basic_block_dcn", "reppoints"])
def test_what_stays_refused(what):
    """RepPoints is not ported and a plugin at a position the JAX package
    never runs is refused: the port refuses them by name; DCN on a
    BasicBlock raises in both packages."""
    if what == "reppoints":
        model = dict(Config.fromfile(
            "configs/reppoints/reppoints_moment_r50_fpn_1x_coco.py").model)
        with pytest.raises((KeyError, NotImplementedError),
                           match="RepPoints"), torch.device("meta"):
            build_detector(model)
        return
    if what == "plugins":
        # plugins run now; one at a position the JAX package
        # never runs stays refused
        cfg = dict(_TINY_BACKBONE, plugins=[dict(
            cfg=dict(type="ContextBlock", ratio=1. / 16),
            stages=(False, True, True, True), position="after_conv1")])
        with pytest.raises(NotImplementedError, match="plugins"):
            build_from_cfg(cfg, MODELS)
        return
    cfg = dict(type="ResNet", depth=18, dcn=dict(type="DCN"),
               stage_with_dcn=(False, True, True, True))
    with pytest.raises(NotImplementedError, match="BasicBlock"):
        build_from_cfg(copy.deepcopy(cfg), MODELS)
    with pytest.raises(NotImplementedError, match="BasicBlock"):
        j_build_from_cfg(copy.deepcopy(cfg), J_MODELS).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


BUILT = sorted(p[len("configs/"):] for p in glob.glob("configs/dcn/*.py")) + [
    "fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_fpn_gn-head_dcn_1x_coco.py",
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py"]


@pytest.mark.parametrize("config", BUILT)
def test_the_dcn_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    deform = [m for m in det.modules() if isinstance(m, dc.DeformConv2dPack)]
    assert deform or getattr(det, "roi_pool_pack", None) is not None
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


@pytest.mark.parametrize("root", ["configs/dcn", "configs/vfnet"])
def test_the_sweep_builds_every_deformable_config(root):
    """``tools/config_sweep.py`` over the slice's config directories: every
    config builds, none is refused."""
    from dsl_tpu_torch.tools.config_sweep import sweep

    total, built, refused = sweep(root)
    assert total == built == len(glob.glob(f"{root}/*.py")) and not refused


def test_a_deformable_convs_bias_is_a_bias_here_not_in_jax():
    """A difference by design: ``paramwise_cfg``'s ``bias_lr_mult`` /
    ``bias_decay_mult`` reach a deformable tower conv's bias in the port
    (mmcv's ``bias``), not in the JAX package, whose rule reads the flax
    leaf's name (``cls_conv1_bias``); every other parameter is classed
    alike. No config of the repo sets bias multipliers on a DCN head."""
    from dsl_tpu.models.dense_heads.fcos_head import FCOSHead as JFCOSHead
    from dsl_tpu.train.optim import is_bias_param as j_is_bias
    from dsl_tpu_torch.models.dense_heads.fcos_head import FCOSHead
    from dsl_tpu_torch.train.optim import is_bias_param

    # one level: the classes do not depend on the levels
    kw = {k: v for k, v in TINY_FCOS_DCN["bbox_head"].items() if k != "type"}
    kw["strides"] = [8]
    shapes = jax.eval_shape(JFCOSHead(**kw).init, jax.random.PRNGKey(0),
                            (jnp.zeros((1, 8, 12, 32)),))
    port = FCOSHead(**kw)
    flags = {f"bbox_head.{n}": torch.full(p.shape, float(is_bias_param(port, n)))
             for n, p in port.named_parameters()}
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_flax(flags)["params"]))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map_with_path(
            lambda path, _: j_is_bias(path),
            {"bbox_head": U._plain(shapes)["params"]})))
    differ = sorted(jax.tree_util.keystr(k) for k in want
                    if bool(np.asarray(got[k]).all()) != bool(want[k]))
    assert differ == ["['bbox_head']['cls_conv1_bias']",
                      "['bbox_head']['reg_conv1_bias']"]
