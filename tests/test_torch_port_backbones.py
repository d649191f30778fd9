"""The port's RegNet, ResNeSt, Res2Net and MobileNetV2 against the JAX
package.

Seeded numpy inputs through each JAX module and its port, f32, on the
tiny detectors of ``synthetic_data`` (``TINY_REGNET_MASK``: RegNetX-400MF,
the smallest arch; ``TINY_RESNEST_FASTER``: ResNeSt-50 with a 16-wide
stem; ``TINY_RES2NET_FASTER``: Res2Net-50 at base width 16;
``TINY_SSD_MOBILENET``: MobileNetV2 at a quarter width under an FPN and
SSD's head), at 64x96:

- each backbone's levels and its neck's: 1e-5 of the largest magnitude;
- ``SABottleneck`` at radix 1 (the sigmoid) and 2, strided (the r-softmax
  over JAX's radix-major splits, the avd pool, the avg-down shortcut), and
  ``Bottle2neck`` as a stage's strided first block and as a later one:
  1e-5 of the largest magnitude;
- ``generate_regnet``'s widths and depths for the 8 arches: equal to the
  JAX package's (numpy only);
- a Res2Net-50 and a ResNeSt-50 refuse a 40x40 input in both packages
  (the shortcut pools in floor mode, the main branch rounds up);
- the weight bridge both ways under mmdet's names, an mmdet-keyed
  ``.pth`` loaded, and the keys the JAX package has no counterpart for
  refused naming them (a Res2Net deep stem, a MobileNetV2 ``conv2``, DCN
  offsets);
- the frozen sets at ``frozen_stages`` -1 and 1 against the JAX package's
  optimizer mask;
- every config of ``configs/regnet/``, ``configs/resnest/`` and
  ``configs/res2net/`` and the two MobileNetV2 SSDs built on the meta
  device (the mdconv RegNet with its deformable convs), with the JAX
  package's parameter counts for six.
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
from dsl_tpu.models.backbones import regnet as j_regnet
from dsl_tpu.models.backbones import res2net as j_res2net
from dsl_tpu.models.backbones import resnest as j_resnest
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.train.optim import frozen_backbone_mask as j_frozen_mask
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.single_stage import empty_detector
from dsl_tpu_torch.models.backbones import regnet, res2net, resnest
from dsl_tpu_torch.train.optim import frozen_backbone_mask
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_REGNET_MASK, TINY_RES2NET_FASTER, TINY_RESNEST_FASTER,
    TINY_SSD_MOBILENET)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
REL = 1e-5
TINY = {"regnet": TINY_REGNET_MASK, "resnest": TINY_RESNEST_FASTER,
        "res2net": TINY_RES2NET_FASTER, "mobilenet_v2": TINY_SSD_MOBILENET}
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py": 34635184,
    "regnet/retinanet_regnetx-800MF_fpn_1x_coco.py": 17238036,
    "resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py":
        43679264,
    "resnest/cascade_mask_rcnn_s101_fpn_syncbn-backbone+head_mstrain_1x_coco.py":
        94756030,
    "res2net/faster_rcnn_r2_50_fpn_coco.py": 41895144,
    "ssd/ssd_mobilenetv2_coco.py": 10761718,
    "ssd/ssdlite_mobilenetv2_scratch_600e_coco.py": 9423092,
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py": 36980269}


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    got = U.nhwc(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


_PAIRS: dict = {}


def pair(name: str):
    """The JAX detector of ``TINY[name]``, its seeded variables and the
    port's detector with them (eval mode), traced once."""
    if name not in _PAIRS:
        cfg = TINY[name]
        det = j_build(copy.deepcopy(cfg))
        shapes = jax.eval_shape(
            lambda r, x: init_detector_variables(det, r, x),
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
        var = {k: U._plain(v) for k, v in fill_variables(dict(shapes)).items()}
        port = empty_detector(copy.deepcopy(cfg))
        port.load_state_dict(flax_to_state_dict(var))
        _PAIRS[name] = det, var, port.eval()
    return _PAIRS[name]


def _levels(module, images):
    feats = module.backbone(images)
    return feats, module.neck(feats)


@pytest.mark.parametrize("name", sorted(TINY))
def test_levels_match_jax(name):
    det, var, port = pair(name)
    x = U.images(5, B, HW)
    want = U.jax_run(lambda v, x_: det.apply(v, x_, method=_levels),
                     var, jnp.asarray(x))
    with torch.no_grad():
        got = _levels(port, U.nchw(x))
    assert len(got[0]) == len(want[0]) == 4
    assert len(got[1]) == len(want[1]) == 5
    for g, w in zip(got[0] + got[1], tuple(want[0]) + tuple(want[1])):
        assert rel_err(g, w) < REL


def _module_pair(jmodule, module, x, seed: int, path: str):
    """A JAX block's seeded variables (traced on ``x``) in the port's
    block through the weight bridge, placed at ``path`` of a backbone."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.asarray(x))
    var = fill_variables(U._plain(shapes), seed)
    tree = {}
    for col in ("params", "batch_stats"):
        tree[col] = {"backbone": {path: var.get(col, {})}}
    sd = flax_to_state_dict(tree)
    prefix = f"backbone.{path.replace('_', '.')}."
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return var, module.eval()


@pytest.mark.parametrize("radix,stride", [(2, 2), (1, 1)])
def test_split_attention_block_matches_jax(radix, stride):
    x = np.random.RandomState(radix + stride).randn(2, 10, 12, 64).astype(
        np.float32)
    jblock = j_resnest.SABottleneck(planes=16, stride=stride, radix=radix)
    var, block = _module_pair(
        jblock, resnest.SABottleneck(64, 16, stride, radix), x,
        radix * stride, "layer2_0")
    want = U.jax_run(jblock.apply, var, jnp.asarray(x))
    with torch.no_grad():
        got = block(U.nchw(x))
    assert rel_err(got, want) < REL


@pytest.mark.parametrize("stage_type,stride", [("stage", 2), ("normal", 1)])
def test_bottle2neck_matches_jax(stage_type, stride):
    cin = 64 if stage_type == "stage" else 256
    x = np.random.RandomState(stride).randn(2, 10, 14, cin).astype(np.float32)
    jblock = j_res2net.Bottle2neck(planes=64, stride=stride,
                                   stage_type=stage_type)
    var, block = _module_pair(
        jblock, res2net.Bottle2neck(cin, 64, stride, stage_type=stage_type),
        x, 7 + stride, "layer1_1")
    want = U.jax_run(jblock.apply, var, jnp.asarray(x))
    with torch.no_grad():
        got = block(U.nchw(x))
    assert rel_err(got, want) < REL


@pytest.mark.parametrize("arch", sorted(regnet.ARCH_PARAMS))
def test_generate_regnet_is_jax(arch):
    p = regnet.ARCH_PARAMS[arch]
    assert p == j_regnet.ARCH_PARAMS[arch]
    got = regnet.generate_regnet(p["w0"], p["wa"], p["wm"], p["depth"],
                                 p["group_w"])
    want = j_regnet.generate_regnet(p["w0"], p["wa"], p["wm"], p["depth"],
                                    p["group_w"])
    assert got == want
    assert len(got[0]) == 4 and sum(got[1]) == p["depth"]


@pytest.mark.parametrize("kind", ["Res2Net", "ResNeSt"])
def test_an_odd_stage_input_is_refused_in_both(kind):
    """At 40x40 layer2 gives 5x5: layer3's 3x3/2 main branch 3x3, its
    floor-mode shortcut pool 2x2, in both packages; the port takes 64x64."""
    from dsl_tpu.registry import MODELS as J_MODELS
    from dsl_tpu_torch.registry import MODELS

    # (two scales: the same pools, a third of Res2Net's convs to trace)
    kw = dict(depth=50, **(dict(scales=2) if kind == "Res2Net" else {}))
    jnet = J_MODELS.get(kind)(**kw)
    with torch.device("meta"):
        net = MODELS.get(kind)(**kw)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 40, 40, 3)))
    with pytest.raises(RuntimeError, match="broadcast|must match the size"):
        net(torch.zeros(1, 3, 40, 40, device="meta"))
    # (the levels test runs both packages at 64x96)
    out = net(torch.zeros(1, 3, 64, 64, device="meta"))
    assert [tuple(o.shape[2:]) for o in out] == [(16, 16), (8, 8), (4, 4), (2, 2)]


@pytest.mark.parametrize("name", sorted(TINY))
def test_bridge_round_trip_and_mmdet_names(name, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair(name)
    sd = port.state_dict()
    want = {"regnet": ["backbone.layer3.0.conv2.weight",
                       "backbone.layer1.0.downsample.1.running_var"],
            "resnest": ["backbone.stem.6.weight", "backbone.stem.7.bias",
                        "backbone.layer2.0.conv2.fc1.weight",
                        "backbone.layer2.0.conv2.norm1.running_mean",
                        "backbone.layer4.0.downsample.1.weight",
                        "backbone.layer1.0.downsample.2.bias"],
            "res2net": ["backbone.conv1.weight", "backbone.layer2.1.convs.2.weight",
                        "backbone.layer3.0.bns.0.running_var",
                        "backbone.layer2.0.downsample.1.weight"],
            "mobilenet_v2": ["backbone.conv1.conv.weight",
                             "backbone.conv1.bn.running_mean",
                             "backbone.layer1.0.depthwise_conv.conv.weight",
                             "backbone.layer2.1.expand_conv.bn.bias",
                             "backbone.layer7.0.linear_conv.conv.weight"]}[name]
    assert set(want) <= set(sd)
    if name == "resnest":
        assert tuple(sd["backbone.layer2.0.conv2.fc1.weight"].shape[2:]) == (1, 1)
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        ref = dict(jax.tree_util.tree_leaves_with_path(var[col]))
        assert sorted(got, key=str) == sorted(ref, key=str)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v)
    again = flax_to_state_dict(back)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    # an mmdet-keyed file of the backbone's tensors loads into them
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()
                               if k.startswith("backbone.")}}, path)
    fresh = empty_detector(copy.deepcopy(TINY[name]))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not unexpected and not any(k.startswith("backbone.")
                                      for k in missing)
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items()
               if k.startswith("backbone."))


@pytest.mark.parametrize("name,key", [
    ("res2net", "backbone.stem.0.weight"),
    ("res2net", "backbone.layer2.0.convs.0.conv_offset.weight"),
    ("regnet", "backbone.layer3.1.conv2.conv_offset.bias"),
    ("mobilenet_v2", "backbone.conv2.conv.weight")])
def test_keys_without_a_jax_counterpart_are_refused(name, key, tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, _, port = pair(name)
    sd = dict(port.state_dict(), **{key: torch.zeros(1)})
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": sd}, path)
    for load in (load_weights, load_torch_detector):
        with pytest.raises(KeyError, match=key.replace(".", r"\.")):
            load(str(path), empty_detector(copy.deepcopy(TINY[name])))


@pytest.mark.parametrize("frozen_stages", [-1, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_the_frozen_set_is_jax_mask(name, frozen_stages):
    _, var, _ = pair(name)
    want = U._as_bool(j_frozen_mask(var["params"], frozen_stages))
    cfg = copy.deepcopy(TINY[name])
    cfg["backbone"]["frozen_stages"] = frozen_stages
    if name == "resnest":
        # neither package's ResNeSt takes frozen_stages: the optimizer mask
        # alone freezes, by name
        for build in (j_build, build_detector):
            with pytest.raises(TypeError, match="frozen_stages"), \
                    torch.device("meta"):
                build(copy.deepcopy(cfg))
        cfg = TINY[name]
    with torch.device("meta"):
        port = build_detector(copy.deepcopy(cfg))
    mask = frozen_backbone_mask(port, frozen_stages)
    flags = {k: torch.full(p.shape, float(mask[k]))
             for k, p in port.named_parameters()}
    assert U._as_bool(state_dict_to_flax(flags)["params"]) == want
    if name != "resnest":
        assert mask == {k: not p.requires_grad
                        for k, p in port.named_parameters()}
    stages = sorted({k.split(".")[1] for k, v in mask.items() if v})
    assert stages == ([] if frozen_stages < 0 else
                      ["layer1"] if name == "resnest" else
                      ["conv1", "layer1"] if name == "mobilenet_v2" else
                      ["bn1", "conv1", "layer1"])


BUILT = sorted(p[len("configs/"):] for p in
               glob.glob("configs/regnet/*.py") + glob.glob("configs/resnest/*.py")
               + glob.glob("configs/res2net/*.py")
               + glob.glob("configs/ssd/ssd*mobilenetv2*.py"))


@pytest.mark.parametrize("config", BUILT)
def test_the_backbone_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    kind = model["backbone"]["type"]
    with torch.device("meta"):
        det = build_detector(model)
    assert type(det.backbone).__name__ == kind
    from dsl_tpu_torch.ops.deform_conv import DeformConv2dPack
    assert any(isinstance(m, DeformConv2dPack) for m in det.modules()) == (
        "mdconv" in config)
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]
