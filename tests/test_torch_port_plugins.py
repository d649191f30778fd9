"""The port's ResNet plugins (GCNet's ContextBlock, GeneralizedAttention)
against the JAX package.

Seeded numpy inputs through each JAX module and its port, f32, tolerance
1e-5 of the largest magnitude of what is compared (outputs, and the
gradients of the input and of every parameter through the weight
bridge, for a seeded cotangent):

- ``ContextBlock`` with attention and average pooling, ``channel_add``
  and ``channel_mul`` (its LayerNorm at flax's epsilon 1e-6 and fast
  variance; an input whose context has a small spread tells 1e-6 from
  torch's 1e-5);
- ``GeneralizedAttention`` with terms ``'1111'``, ``'0010'`` and
  ``'0100'``, ``kv_stride`` 1 and 2 on a 7x9 map (odd both ways), and a
  ``spatial_range`` of 2 (the -1e9 mask);
- a ResNet-50 at a quarter width with ContextBlock in c3-c5 and
  GeneralizedAttention in c4-c5: its levels;
- what stays refused: a plugin on a BasicBlock (in both packages), a
  plugin at a position the JAX package never runs (the port alone: JAX
  skips it), another plugin type;
- the weight bridge both ways, mmdet's ``context_block`` names (an
  mmdet-layout ``.pth`` of the tiny GCNet Mask R-CNN loads by its own
  keys), mmcv's GeneralizedAttention keys refused naming the key;
- every config of ``configs/gcnet`` and ``configs/empirical_attention``
  built on the meta device, with the JAX package's parameter counts for
  four.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models.backbones.resnet import ResNet as JResNet
from dsl_tpu.models.layers import ContextBlock as JContextBlock
from dsl_tpu.models.layers import GeneralizedAttention as JGeneralizedAttention
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.backbones.resnet import ResNet
from dsl_tpu_torch.models.detectors.single_stage import empty_detector
from dsl_tpu_torch.models.layers import ContextBlock, GeneralizedAttention
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_ATTENTION_FASTER, TINY_GCB_MASK_RCNN)

torch.set_num_threads(2)

REL = 1e-5
VANISHING = 1e-4
B = 2
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {
    "gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py": 54397245,
    "gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_dconv_c3-c5_r16_gcb_c3-c5_1x_coco.py":
        98018584,
    "empirical_attention/faster_rcnn_r50_fpn_attention_0010_1x_coco.py":
        45298153,
    "empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_coco.py":
        46775785}


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def nhwc(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 2, 3, 1)


PREFIX = {"context_block": "backbone.layer2.0.context_block.",
          "gen_attention_block": "backbone.layer2.0.gen_attention_block."}


def _wrap(tree: dict) -> dict:
    """A plugin's flax tree as the first plugin of a backbone block."""
    return {"backbone": {"layer2_0": {"plugin0": tree}}}


def plugin_against_jax(jmod, port, abbr: str, x: np.ndarray, seed: int):
    """The JAX plugin's output and every gradient (of the input and of its
    parameters, for a seeded cotangent) against the port's, the weights
    crossing the bridge at a block's ``plugin0``."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    var = fill_variables(U._plain(shapes), seed)
    sd = flax_to_state_dict({"params": _wrap(var["params"])})
    prefix = PREFIX[abbr]
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    g = np.random.RandomState(seed + 1).randn(*x.shape).astype(np.float32)

    def loss(v, x_):
        out = jmod.apply(v, x_)
        return (out * g).sum(), out

    (_, want), grads = U.jax_run(jax.value_and_grad(loss, argnums=(0, 1),
                                                    has_aux=True),
                                 var, jnp.asarray(x))
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    out = port(xt)
    (out * torch.tensor(g.transpose(0, 3, 1, 2))).sum().backward()
    assert rel(nhwc(out.detach()), want) < REL
    assert rel(nhwc(xt.grad), grads[1]) < REL
    # an unused parameter (the key conv where no term reads the keys) has
    # no gradient here, a zero one in JAX
    got = state_dict_to_flax({
        prefix + n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in port.named_parameters()})["params"]
    ref = _wrap(U._plain(grads[0]["params"]))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert sorted(got_leaves, key=str) == sorted(ref_leaves, key=str)
    top = max(float(np.abs(np.asarray(v)).max()) for v in ref_leaves.values())
    for k, v in ref_leaves.items():
        # a gradient that vanishes in exact arithmetic (the attention
        # pool's bias: a softmax ignores a shift) is rounding in both
        floor = max(float(np.abs(np.asarray(v)).max()), VANISHING * top)
        if k[-1].key == "gamma":
            # the output scale's gradient sums g * out / gamma over every
            # output element: held to the sum of those terms' magnitudes
            gamma = float(var["params"]["gamma"])
            floor = float(np.abs(g * (np.asarray(want) - x)).sum()
                          / abs(gamma))
        assert np.abs(np.asarray(got_leaves[k]) - np.asarray(v)).max() \
            <= REL * floor, k
    return want


@pytest.mark.parametrize("pooling,fusion", [
    ("att", ("channel_add",)), ("avg", ("channel_add",)),
    ("att", ("channel_mul",)), ("att", ("channel_mul", "channel_add"))],
    ids=["att_add", "avg_add", "att_mul", "att_mul_add"])
def test_context_block_matches_jax(pooling, fusion):
    rng = np.random.RandomState(3)
    # a small spread around a large mean: the transform's LayerNorm sees a
    # variance near its epsilon
    x = (5.0 + 0.01 * rng.randn(B, 7, 9, 16)).astype(np.float32)
    if pooling == "avg":
        x = rng.randn(B, 7, 9, 16).astype(np.float32)
    jmod = JContextBlock(ratio=1. / 4, pooling_type=pooling,
                         fusion_types=fusion)
    port = ContextBlock(16, 1. / 4, pooling, fusion)
    plugin_against_jax(jmod, port, "context_block", x, 4)


def test_the_context_layer_norm_is_flaxs():
    """The transform's LayerNorm at flax's epsilon 1e-6 and fast variance,
    not ``nn.LayerNorm``'s 1e-5: on a context of spread 1e-3 the two
    differ by far more than the tolerance."""
    import flax.linen as nn

    from dsl_tpu_torch.models.layers import _ContextLayerNorm

    x = (1.0 + 1e-3 * np.random.RandomState(5).randn(2, 8)).astype(np.float32)
    want = U.jax_run(lambda v: nn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}}, v),
        jnp.asarray(x))
    got = _ContextLayerNorm(8)(torch.from_numpy(x)[:, :, None, None])[:, :, 0, 0]
    torch_ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (8,))
    assert rel(got.detach(), want) < REL
    assert rel(torch_ln, want) > 100 * REL


ATTENTION_CASES = [("1111", 2, -1), ("0010", 2, -1), ("0100", 1, -1),
                   ("1111", 1, 2), ("0100", 2, 2)]


@pytest.mark.parametrize("bits,stride,spatial_range", ATTENTION_CASES,
                         ids=lambda v: str(v))
def test_generalized_attention_matches_jax(bits, stride, spatial_range):
    x = np.random.RandomState(6).randn(B, 7, 9, 32).astype(np.float32)
    kw = dict(num_heads=4, attention_type=bits, kv_stride=stride,
              spatial_range=spatial_range)
    port = GeneralizedAttention(32, **kw)
    plugin_against_jax(JGeneralizedAttention(**kw), port,
                       "gen_attention_block", x, 7)
    assert (port.query_conv is not None) == (bits[0] == "1" or bits[1] == "1")


_TINY_BACKBONE = dict(TINY_GCB_MASK_RCNN["backbone"],
                      plugins=(TINY_GCB_MASK_RCNN["backbone"]["plugins"]
                               + TINY_ATTENTION_FASTER["backbone"]["plugins"]))


def test_resnet_with_plugins_matches_jax():
    """ContextBlock in c3-c5, GeneralizedAttention in c4-c5 of a ResNet-50
    at a quarter width: the four levels."""
    cfg = copy.deepcopy(_TINY_BACKBONE)
    jcfg = {k: v for k, v in cfg.items() if k != "type"}
    jmod = JResNet(**jcfg)
    x = U.images(8, 1, (64, 96))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    var = fill_variables(U._plain(shapes), 9)
    sd = flax_to_state_dict({col: {"backbone": var.get(col, {})}
                             for col in ("params", "batch_stats")})
    port = ResNet(**jcfg)
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    assert isinstance(port.layer2[0].context_block, ContextBlock)
    assert isinstance(port.layer4[2].gen_attention_block, GeneralizedAttention)
    assert not hasattr(port.layer2[0], "gen_attention_block")
    assert not hasattr(port.layer1[0], "context_block")
    want = U.jax_run(jmod.apply, var, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(U.nchw(x))
    assert len(got) == len(want) == 4
    for gl, wl in zip(got, want):
        assert rel(nhwc(gl), wl) < REL


@pytest.mark.parametrize("what", ["basic_block", "position", "type"])
def test_what_stays_refused(what):
    plugin = dict(cfg=dict(type="ContextBlock", ratio=1. / 4),
                  stages=(False, True, True, True), position="after_conv3")
    if what == "basic_block":
        cfg = dict(depth=18, plugins=[plugin])
        with pytest.raises(NotImplementedError, match="BasicBlock"):
            ResNet(**copy.deepcopy(cfg))
        with pytest.raises(NotImplementedError, match="BasicBlock"):
            JResNet(**cfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
    elif what == "position":
        with pytest.raises(NotImplementedError, match="after_conv1"):
            ResNet(depth=50, plugins=[dict(plugin, position="after_conv1")])
    else:
        with pytest.raises(NotImplementedError, match="NonLocal2d"):
            ResNet(depth=50, plugins=[dict(plugin, cfg=dict(type="NonLocal2d"))])


_PAIRS: dict = {}


def pair(cfg: dict):
    """The tiny detector's seeded flax variables and the port's detector
    with them, traced once."""
    from dsl_tpu.models import build_detector as j_build
    from dsl_tpu.models.detectors.single_stage import init_detector_variables

    key = repr(cfg)
    if key not in _PAIRS:
        det = j_build(copy.deepcopy(cfg))
        shapes = jax.eval_shape(
            lambda r, x: init_detector_variables(det, r, x),
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
        var = {k: U._plain(v) for k, v in fill_variables(dict(shapes)).items()}
        port = empty_detector(copy.deepcopy(cfg))
        port.load_state_dict(flax_to_state_dict(var))
        _PAIRS[key] = var, port.eval()
    return _PAIRS[key]


@pytest.mark.parametrize("cfg", [TINY_GCB_MASK_RCNN, TINY_ATTENTION_FASTER],
                         ids=["gcb", "attention"])
def test_bridge_round_trip_and_mmdet_names(cfg, tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights

    var, port = pair(cfg)
    sd = port.state_dict()
    want = (["backbone.layer2.0.context_block.conv_mask.weight",
             "backbone.layer4.2.context_block.channel_add_conv.0.bias",
             "backbone.layer3.1.context_block.channel_add_conv.1.weight",
             "backbone.layer3.1.context_block.channel_add_conv.3.weight"]
            if cfg is TINY_GCB_MASK_RCNN else
            ["backbone.layer3.0.gen_attention_block.query_conv.weight",
             "backbone.layer4.1.gen_attention_block.geom_fc_x.weight",
             "backbone.layer4.1.gen_attention_block.key_content_bias",
             "backbone.layer3.5.gen_attention_block.gamma"])
    assert set(want) <= set(sd)
    if cfg is TINY_GCB_MASK_RCNN:
        # mmcv's LayerNorm([planes, 1, 1])
        assert tuple(sd[want[2]].shape) == (64, 1, 1)
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
    if cfg is TINY_GCB_MASK_RCNN:
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   path)
        fresh = empty_detector(copy.deepcopy(cfg))
        load_weights(str(path), fresh)
        assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
        return
    # mmcv's GeneralizedAttention: its position FCs have no counterpart here
    key = "backbone.layer3.0.gen_attention_block.appr_geom_fc_x.weight"
    torch.save({"state_dict": dict(sd, **{key: torch.zeros(1)})}, path)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        load_weights(str(path), empty_detector(copy.deepcopy(cfg)))


BUILT = sorted(p[len("configs/"):] for d in ("gcnet", "empirical_attention")
               for p in glob.glob(f"configs/{d}/*.py"))


@pytest.mark.parametrize("config", BUILT)
def test_the_plugin_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    plugins = [m for m in det.modules()
               if isinstance(m, (ContextBlock, GeneralizedAttention))]
    assert bool(plugins) == ("gcb" in config or "attention" in config)
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]
