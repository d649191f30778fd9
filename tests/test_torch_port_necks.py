"""The port's other necks (PAFPN, FPN_CARAFE with ``carafe``, BFP and
the stacked ``[FPN, BFP]``, NAS-FPN, NAS-FCOS's FPN, FPG) against the JAX
package.

Seeded numpy inputs through each JAX module and its port, f32, tolerance
1e-5 of the largest magnitude of what is compared:

- ``carafe``: the output and the gradients of the source and of the
  kernels (5x5 taps at scale 2, on an odd 7x9 source);
- CARAFE's channel order: the JAX package's content encoder, read as
  mmcv's (``F.pixel_shuffle``) without the bridge's permutation, gives
  other levels; with it, the same;
- each neck's levels on seeded backbone levels of the tiny detectors'
  widths (32 wide; NAS-FPN and FPG at ``stack_times`` 2; BFP with
  ``refine_type`` 'conv', None and 'non_local'), and the gradient of the
  inputs through NAS-FPN's and FPG's resizes;
- the JAX package's departures from mmdet, which the port keeps: PAFPN's
  extra levels are convs at ``add_extra_convs=False``, BFP runs no refine
  at 'non_local';
- an input whose P5 is odd: NAS-FPN and FPG raise in both packages (the
  port naming the neck and the sizes);
- FPG-RetinaNet: the levels at strides 4-64 under anchors laid at 8-128,
  in both packages alike (the JAX package's levels and anchors);
- the weight bridge both ways on the tiny detectors, mmdet's names where
  the JAX module maps one to one (PAFPN, BFP's ``refine.conv``, CARAFE's
  packs) and the keys that raise on load (PAFPN's extra conv that mmdet
  lacks, a non-local refine, CARAFE's extra levels, an mmdet FPG);
- every config of ``configs/pafpn``, ``configs/carafe``, ``configs/nas_fpn``
  and ``configs/fpg`` built on the meta device, with the JAX package's
  parameter counts for five.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.ops.misc_ops import carafe as j_carafe
from dsl_tpu.registry import MODELS as J_MODELS
from dsl_tpu.registry import build_from_cfg as j_build_from_cfg
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.single_stage import empty_detector
from dsl_tpu_torch.models.necks.channel_mapper import build_neck
from dsl_tpu_torch.ops.misc_ops import carafe
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_CARAFE_FASTER, TINY_FPG_FASTER, TINY_FPG_RETINANET,
    TINY_LIBRA_FASTER, TINY_NASFPN_RETINANET, TINY_PAFPN_FASTER)

torch.set_num_threads(2)

REL = 1e-5
B = 2
HW = (64, 128)                # FPG's levels halve evenly from C2 to P6
NAS_HW = (64, 96)             # NAS-FPN's P6 and P7 at 1x1 (at 64x128 its
                              # P7 pools a 1x2 P6 to no rows in JAX)
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {
    "pafpn/faster_rcnn_r50_pafpn_1x_coco.py": 45883616,
    "carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py": 41975500,
    "nas_fpn/retinanet_r50_fpn_crop640_50e_coco.py": 59978548,
    "fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py": 90170848,
    "fpg/retinanet_r50_fpg-chn128_crop640_50e_coco.py": 38760244}


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def nhwc(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 2, 3, 1)


def test_carafe_matches_jax():
    rng = np.random.RandomState(0)
    k, s = 5, 2
    x = rng.randn(B, 7, 9, 6).astype(np.float32)
    logits = rng.randn(B, 14, 18, k * k).astype(np.float32)
    masks = np.asarray(jax.nn.softmax(logits, axis=-1))
    g = rng.randn(B, 14, 18, 6).astype(np.float32)

    def loss(x_, m_):
        out = j_carafe(x_, m_, kernel_size=k, scale=s)
        return (out * g).sum(), out

    (_, want), (gx, gm) = U.jax_run(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), jnp.asarray(x), jnp.asarray(masks))
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    mt = torch.tensor(masks.transpose(0, 3, 1, 2), requires_grad=True)
    out = carafe(xt, mt, k, s)
    (out * torch.tensor(g.transpose(0, 3, 1, 2))).sum().backward()
    assert rel(nhwc(out.detach()), want) < REL
    assert rel(nhwc(xt.grad), gx) < REL
    assert rel(nhwc(mt.grad), gm) < REL


def neck_levels(n_in: int, seed: int, hw=HW, widths=(64, 128, 256, 512)):
    """Seeded backbone levels at strides 4, 8, 16, 32 of an ``hw`` input
    (NHWC), the last ``n_in`` of them."""
    rng = np.random.RandomState(seed)
    levels = [rng.randn(1, -(-hw[0] // st), -(-hw[1] // st), c)
              .astype(np.float32) for st, c in zip((4, 8, 16, 32), widths)]
    return levels[4 - n_in:]


def _fpn(**kw):
    return dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
                start_level=0, num_outs=5, **kw)


def _bfp(refine):
    return dict(type="BFP", in_channels=32, num_levels=5, refine_level=2,
                refine_type=refine)


NECKS = {
    "pafpn": (dict(_fpn(), type="PAFPN"), 4),
    "pafpn_on_input": (dict(_fpn(add_extra_convs="on_input",
                                 relu_before_extra_convs=True),
                            type="PAFPN", start_level=1, num_outs=5), 4),
    "fpn_carafe": (dict(type="FPN_CARAFE", in_channels=[64, 128, 256, 512],
                        out_channels=32, num_outs=5), 4),
    "fpn_bfp_non_local": ([_fpn(), _bfp("non_local")], 4),
    "fpn_bfp_conv": ([_fpn(), _bfp("conv")], 4),
    "fpn_bfp_none": ([_fpn(), _bfp(None)], 4),
    "nas_fpn": (dict(type="NASFPN", in_channels=[128, 256, 512],
                     out_channels=32, num_outs=5, stack_times=2), 3),
    "nasfcos_fpn": (dict(type="NASFCOS_FPN", in_channels=[128, 256, 512],
                         out_channels=32, num_outs=5), 3),
    "fpg": (dict(type="FPG", in_channels=[64, 128, 256, 512],
                 out_channels=32, num_outs=5, stack_times=2), 4)}


def jax_neck(cfg):
    if isinstance(cfg, list):
        from dsl_tpu.models.necks.channel_mapper import SequentialNeck

        return SequentialNeck(necks=tuple(
            j_build_from_cfg(copy.deepcopy(c), J_MODELS) for c in cfg))
    return j_build_from_cfg(copy.deepcopy(cfg), J_MODELS)


class _Widths(torch.nn.Module):
    """A stand-in backbone giving ``build_neck`` its level widths."""

    def __init__(self, widths):
        super().__init__()
        self.out_channels = tuple(widths)


def neck_pair(name: str, seed: int = 1):
    cfg, n_in = NECKS[name]
    levels = neck_levels(n_in, seed, NAS_HW if name == "nas_fpn" else HW)
    jmod = jax_neck(cfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in levels])
    var = fill_variables(U._plain(shapes), seed + 1)
    sd = flax_to_state_dict({col: {"neck": var.get(col, {})}
                             for col in ("params", "batch_stats")})
    port = build_neck(copy.deepcopy(cfg),
                      _Widths([f.shape[-1] for f in levels]))
    port.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    return jmod, var, port.eval(), levels


@pytest.mark.parametrize("name", sorted(NECKS))
def test_neck_levels_match_jax(name):
    jmod, var, port, levels = neck_pair(name)
    grad = name in ("nas_fpn", "fpg")
    g = [np.random.RandomState(3 + i).randn(*o.shape).astype(np.float32)
         for i, o in enumerate(jax.eval_shape(
             jmod.apply, var, [jnp.asarray(f) for f in levels]))]

    def loss(fs):
        outs = jmod.apply(var, fs)
        return sum((o * gi).sum() for o, gi in zip(outs, g)), outs

    (_, want), want_grads = U.jax_run(jax.value_and_grad(loss, has_aux=True),
                                      [jnp.asarray(f) for f in levels])
    xs = [torch.tensor(f.transpose(0, 3, 1, 2), requires_grad=grad)
          for f in levels]
    got = port(xs)
    assert len(got) == len(want) == 5
    for gl, wl in zip(got, want):
        assert rel(nhwc(gl.detach()), wl) < REL
    if grad:
        sum((o * torch.tensor(gi.transpose(0, 3, 1, 2))).sum()
            for o, gi in zip(got, g)).backward()
        for x, wg in zip(xs, want_grads):
            assert rel(nhwc(x.grad), wg) < REL


def test_carafe_channel_order_is_permuted_by_the_bridge():
    """The JAX package's content encoder is sub-pixel-major; read as
    mmcv's tap-major channels without the bridge's permutation the levels
    differ."""
    jmod, var, port, levels = neck_pair("fpn_carafe")
    want = U.jax_run(jmod.apply, var, [jnp.asarray(f) for f in levels])
    enc = var["params"]["up1"]["content_encoder"]["kernel"]
    with torch.no_grad():
        raw = torch.from_numpy(np.asarray(enc).transpose(3, 2, 0, 1).copy())
        assert not torch.equal(port.upsample_modules[0].content_encoder.weight,
                               raw)
        port.upsample_modules[0].content_encoder.weight.copy_(raw)
        port.upsample_modules[0].content_encoder.bias.copy_(torch.from_numpy(
            np.asarray(var["params"]["up1"]["content_encoder"]["bias"])))
        got = port([torch.from_numpy(f.transpose(0, 3, 1, 2)) for f in levels])
    assert rel(nhwc(got[0]), want[0]) > 1e-3


def test_what_the_port_keeps_of_jax_not_mmdet():
    """PAFPN's extra level is a stride-2 conv at ``add_extra_convs=False``
    (mmdet max-pools); BFP at 'non_local' has no refine (mmdet runs a
    NonLocal2d)."""
    _, _, pafpn, _ = neck_pair("pafpn")
    assert len(pafpn.fpn_convs) == 5 and pafpn.fpn_convs[4].conv.stride == (2, 2)
    _, var, seq, _ = neck_pair("fpn_bfp_non_local")
    assert seq[1].refine is None and "necks_1" not in var.get("params", {})
    _, _, conv, _ = neck_pair("fpn_bfp_conv")
    assert conv[1].refine is not None


@pytest.mark.parametrize("name", ["nas_fpn", "fpg"])
def test_an_odd_p5_is_refused_in_both(name):
    """At 224x320 P5 is 7x10: NAS-FPN's P6 pools it to 3x5 and repeats it
    back to 12 rows for P4's 14; FPG's P6 is 4x5, repeated once for P5's
    7. Both packages raise."""
    cfg, n_in = NECKS[name]
    levels = neck_levels(n_in, 4, hw=(224, 320))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jax_neck(cfg).init, jax.random.PRNGKey(0),
                       [jnp.asarray(f) for f in levels])
    port = build_neck(copy.deepcopy(cfg),
                      _Widths([f.shape[-1] for f in levels]))
    with pytest.raises(ValueError, match=f"{cfg['type']}: levels of"):
        port([torch.from_numpy(f.transpose(0, 3, 1, 2)) for f in levels])


_PAIRS: dict = {}


def pair(cfg: dict):
    """The JAX detector of ``cfg``, its seeded variables and the port's
    detector with them (eval mode), traced once."""
    key = repr(cfg)
    if key not in _PAIRS:
        det = j_build(copy.deepcopy(cfg))
        hw = NAS_HW if cfg is TINY_NASFPN_RETINANET else HW
        shapes = jax.eval_shape(
            lambda r, x: init_detector_variables(det, r, x),
            jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
        var = {k: U._plain(v) for k, v in fill_variables(dict(shapes)).items()}
        port = empty_detector(copy.deepcopy(cfg))
        port.load_state_dict(flax_to_state_dict(var))
        _PAIRS[key] = det, var, port.eval()
    return _PAIRS[key]


def test_fpg_retinanet_levels_and_anchors_are_jax():
    """FPG from C2 (start_level 0): levels at strides 4-64 while the head
    lays its anchors at 8-128, in both packages (a fault of both, kept)."""
    det, var, port = pair(TINY_FPG_RETINANET)
    x = U.images(5, 1, HW)
    want = jax.eval_shape(lambda v, x_: det.apply(v, x_), var, jnp.asarray(x))
    with torch.no_grad():
        got = port(U.nchw(x))
    sizes = [tuple(c.shape[1:3]) for c in got[0]]
    assert sizes == [tuple(c.shape[1:3]) for c in want[0]]
    assert sizes[0] == (HW[0] // 4, HW[1] // 4)
    j_anchors = np.asarray(det.bbox_head.make_anchor_generator()
                           .flat_anchors(sizes))
    anchors = port.bbox_head.anchors.flat_anchors(sizes)
    np.testing.assert_array_equal(anchors.numpy(), j_anchors)
    assert port.bbox_head.strides[0] == 8


PAIRED = {"pafpn": TINY_PAFPN_FASTER, "carafe": TINY_CARAFE_FASTER,
          "libra": TINY_LIBRA_FASTER, "nas_fpn": TINY_NASFPN_RETINANET,
          "fpg": TINY_FPG_FASTER}
NAMES = {"pafpn": ["neck.downsample_convs.2.conv.weight",
                   "neck.pafpn_convs.0.conv.bias", "neck.fpn_convs.4.conv.weight"],
         "carafe": ["neck.upsample_modules.2.content_encoder.weight",
                    "neck.upsample_modules.0.channel_compressor.bias",
                    "neck.lateral_convs.3.conv.weight"],
         "libra": ["neck.0.lateral_convs.0.conv.weight",
                   "neck.0.fpn_convs.3.conv.bias"],
         "nas_fpn": ["neck.lateral2.weight", "neck.extra1.bias",
                     "neck.s1_gp_75_6.out_bn.running_var",
                     "bbox_head.cls_convs.4.1.bn.weight",
                     "bbox_head.reg_convs.3.0.conv.weight"],
         "fpg": ["neck.s1_bu4.weight", "neck.s0_td3.bias",
                 "neck.s1_bn0.running_mean", "neck.extra0.weight"]}


@pytest.mark.parametrize("name", sorted(PAIRED))
def test_bridge_round_trip(name):
    _, var, port = pair(PAIRED[name])
    sd = port.state_dict()
    assert set(NAMES[name]) <= set(sd)
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


@pytest.mark.parametrize("name,key", [
    ("pafpn", None), ("carafe", None),
    ("pafpn", "-neck.fpn_convs.4.conv.weight"),
    ("carafe", "neck.lateral_convs.4.conv.weight"),
    ("libra", "neck.1.refine.g.conv.weight"),
    ("fpg", "neck.lateral_convs.0.conv.weight")])
def test_mmdet_names_load_or_raise(name, key, tmp_path):
    """An mmdet-layout ``.pth`` (``module.`` prefixed, under
    ``state_dict``) of the port's own tensors loads by its keys; one key
    that mmdet's module has and the JAX package's has not (``-`` a key
    mmdet's lacks) raises naming it."""
    from dsl_tpu_torch.utils.checkpoint import load_weights

    _, _, port = pair(PAIRED[name])
    sd = dict(port.state_dict())
    if key is not None and key.startswith("-"):
        key = key[1:]
        del sd[key]
    elif key is not None:
        sd[key] = torch.zeros(1)
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = empty_detector(copy.deepcopy(PAIRED[name]))
    if key is None:
        load_weights(str(path), fresh)
        assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
        return
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        load_weights(str(path), fresh)


BUILT = sorted(p[len("configs/"):] for d in ("pafpn", "carafe", "nas_fpn", "fpg")
               for p in glob.glob(f"configs/{d}/*.py"))


@pytest.mark.parametrize("config", BUILT)
def test_the_neck_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    assert type(det.neck).__name__ == model["neck"]["type"]
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]
