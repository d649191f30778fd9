"""The port's HRNet and HRFPN against the JAX package.

Seeded numpy inputs through each JAX module and its port, f32, on
``synthetic_data.TINY_HRNET_FASTER`` / ``TINY_HRNET_FCOS`` (HRNet with one
or two blocks per branch, branches 4 to 32 wide, two stage-4 modules; an
HRFPN 32 wide):

- ``resize_nearest`` against ``jax.image.resize(..., "nearest")``: equal
  (and equal to ``F.interpolate``'s ``"nearest-exact"``, which
  ``"nearest"`` is not where the size does not divide);
- the four branches and the five HRFPN levels at 64x96 and at 72x104, a
  canvas whose branches are halved from odd sizes (18x26 -> 9x13 -> 5x7
  -> 3x4), so the fuse's nearest rule shows: 1e-5 of the largest
  magnitude;
- ``HRFPN`` alone with average and max pooling: 1e-5 of the largest
  magnitude;
- the head outputs of the tiny Faster R-CNN (the levels, the RPN, the RoI
  head; 1e-5 of each output's largest magnitude) and of the tiny FCOS on
  HRNet (1e-5 of the largest magnitude of its kind: its 32-wide GN tower
  is ill-conditioned on the 1x1 level in both frameworks);
- FCOS-HRNet's levels at strides 4 to 64 under a head that lays its
  points at strides 8 to 128, in both packages alike (a fault of both:
  the repo's configs give HRFPN no ``stride``);
- the weight bridge both ways under mmdet's names, and an mmdet-keyed
  ``.pth`` loaded;
- the frozen sets at ``frozen_stages`` -1 and 1 against the JAX package's
  optimizer mask (``conv1``, ``bn1``, ``layer1``; not ``conv2`` / ``bn2``);
- every config of ``configs/hrnet/`` built on the meta device, with the
  JAX package's parameter counts for three.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_util as U
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.necks.hrfpn import HRFPN as JHRFPN
from dsl_tpu.train.optim import frozen_backbone_mask as j_frozen_mask
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.necks.hrfpn import HRFPN
from dsl_tpu_torch.ops.resize import resize_nearest
from dsl_tpu_torch.train.optim import frozen_backbone_mask
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import TINY_HRNET_FASTER, TINY_HRNET_FCOS

torch.set_num_threads(2)

HW = (64, 96)
ODD_HW = (72, 104)
B = 2
REL = 1e-5
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"hrnet/faster_rcnn_hrnetv2p_w32_1x_coco.py": 47279712,
           "hrnet/fcos_hrnetv2p_w18_gn-head_4x4_1x_coco.py": 17502702,
           "hrnet/cascade_mask_rcnn_hrnetv2p_w18_20e_coco.py": 57767666}


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    got = got.detach().numpy()
    if got.ndim == 4 and got.shape != want.shape:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


_PAIRS: dict = {}


def pair(cfg: dict):
    """The JAX detector, its seeded variables and the port's detector with
    them (eval mode), traced once per config."""
    key = repr(cfg)
    if key not in _PAIRS:
        det = j_build(copy.deepcopy(cfg))
        shapes = jax.eval_shape(
            lambda r, x: init_detector_variables(det, r, x),
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
        var = {k: U._plain(v) for k, v in fill_variables(dict(shapes)).items()}
        port = build_detector(copy.deepcopy(cfg))
        port.load_state_dict(flax_to_state_dict(var))
        _PAIRS[key] = det, var, port.eval()
    return _PAIRS[key]


def _flat(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


@pytest.mark.parametrize("src,dst", [(7, 13), (13, 25), (5, 9), (3, 5),
                                     (25, 200), (42, 336), (4, 8)])
def test_resize_nearest_is_jax(src, dst):
    x = np.random.RandomState(src).randn(1, 2, src, src + 1).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, 2, dst, dst + 2), "nearest"))
    got = resize_nearest(torch.tensor(x), (dst, dst + 2)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = F.interpolate(torch.tensor(x), size=(dst, dst + 2),
                          mode="nearest-exact").numpy()
    np.testing.assert_array_equal(exact, want)
    plain = F.interpolate(torch.tensor(x), size=(dst, dst + 2),
                          mode="nearest").numpy()
    assert np.array_equal(plain, want) == (dst % src == 0
                                           and (dst + 2) % (src + 1) == 0)


_FCOS_RUNS: dict = {}


def _parts(module, images, head: bool):
    branches = module.backbone(images)
    levels = module.neck(branches)
    return branches, levels, module.bbox_head(levels) if head else ()


def fcos_run(hw):
    """The tiny FCOS on HRNet on a seeded batch at ``hw``, in both
    packages: (JAX's (branches, levels, head outputs), the port's), one
    jit per canvas; the head at ``HW`` only."""
    if hw not in _FCOS_RUNS:
        det, var, port = pair(TINY_HRNET_FCOS)
        x = U.images(1, B, hw)
        head = hw == HW
        want = U.jax_run(lambda v, x_: det.apply(v, x_, head, method=_parts),
                         var, jnp.asarray(x))
        with torch.no_grad():
            got = _parts(port, U.nchw(x), head)
        _FCOS_RUNS[hw] = want, got
    return _FCOS_RUNS[hw]


@pytest.mark.parametrize("hw", [HW, ODD_HW], ids=["64x96", "72x104"])
def test_branches_and_levels_match_jax(hw):
    want, (branches, levels, _) = fcos_run(hw)
    assert [tuple(b.shape[2:]) for b in branches] == [
        tuple(w.shape[1:3]) for w in want[0]]
    if hw == ODD_HW:
        assert [tuple(b.shape[2:]) for b in branches] == [
            (18, 26), (9, 13), (5, 7), (3, 4)]
    assert len(levels) == 5
    for g, w in zip(list(branches) + list(levels), _flat(want[:2])):
        assert rel_err(g, w) < REL


@pytest.mark.parametrize("pooling", ["AVG", "MAX"])
def test_hrfpn_matches_jax(pooling):
    rng = np.random.RandomState(len(pooling))
    feats = [rng.randn(B, 20 // 2 ** i, 28 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((4, 8, 16, 32))]
    jneck = JHRFPN(in_channels=(4, 8, 16, 32), out_channels=16, num_outs=4,
                   pooling_type=pooling)
    shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    var = fill_variables(U._plain(shapes), 3)
    neck = HRFPN((4, 8, 16, 32), 16, 4, pooling)
    sd = flax_to_state_dict({"params": {"neck": var["params"]}})
    neck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    want = U.jax_run(jneck.apply, var, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = neck([U.nchw(f) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == [(20, 28), (10, 14), (5, 7),
                                                 (2, 3)]
    for g, w in zip(got, want):
        assert rel_err(g, w) < REL


def test_faster_rcnn_head_outputs_match_jax():
    det, var, port = pair(TINY_HRNET_FASTER)
    x = U.images(2, B, HW)
    rois = np.random.RandomState(5).randn(6, 7, 7, 32).astype(np.float32)
    want = U.jax_run(lambda v, x_, r: (det.apply(v, x_), det.apply(
        v, r, method=det.roi_forward)), var, jnp.asarray(x), jnp.asarray(rois))
    with torch.no_grad():
        got = (port(U.nchw(x)), port(U.nchw(rois), stage="roi"))
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) == 5 + 10 + 2
    for g, w in zip(got, want):
        assert rel_err(g, w) < REL


def test_fcos_head_outputs_match_jax():
    """Each output within 1e-5 of its kind's largest magnitude (a 32-wide
    GN tower on the 1x1 level is ill-conditioned in both frameworks)."""
    want, (_, _, got) = fcos_run(HW)
    assert len(got) == len(want[2]) == 3
    for g_kind, w_kind in zip(got, want[2]):
        top = max(float(np.abs(np.asarray(w)).max()) for w in w_kind)
        assert len(g_kind) == len(w_kind) == 5
        for g, w in zip(g_kind, w_kind):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=REL * top)


def test_fcos_hrnet_levels_and_points_are_jax():
    """Both packages put HRFPN's levels at strides 4-64 while the FCOS
    head lays its points at the configured 8-128: the same shapes and the
    same points in both (the fault is both packages')."""
    from dsl_tpu.core.points import MlvlPointGenerator as JPoints
    from dsl_tpu_torch.core.points import MlvlPointGenerator

    det, _, port = pair(TINY_HRNET_FCOS)
    want, (_, _, got) = fcos_run(HW)
    sizes = [tuple(c.shape[1:3]) for c in want[2][0]]
    assert [tuple(c.shape[1:3]) for c in got[0]] == sizes
    assert sizes == [(HW[0] // s, HW[1] // s) for s in (4, 8, 16, 32)] + [(1, 1)]
    strides = list(port.bbox_head.strides)
    assert strides == list(det.bbox_head.strides) == [8, 16, 32, 64, 128]
    np.testing.assert_array_equal(
        MlvlPointGenerator(strides).flat_points(sizes).numpy(),
        np.asarray(JPoints(strides).flat_points(sizes)))
    real = Config.fromfile(
        "configs/hrnet/fcos_hrnetv2p_w18_gn-head_4x4_1x_coco.py").model
    assert "stride" not in real.neck and real.bbox_head.strides == strides


def test_bridge_round_trip_and_mmdet_names(tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair(TINY_HRNET_FASTER)
    sd = port.state_dict()
    assert {"backbone.conv2.weight", "backbone.bn2.running_var",
            "backbone.layer1.0.downsample.0.weight",
            "backbone.transition1.0.0.weight",          # branch 0 adapted
            "backbone.transition1.1.0.0.weight",        # branch 1 new
            "backbone.transition3.3.0.1.running_mean",
            "backbone.stage2.0.branches.1.0.conv2.weight",
            "backbone.stage4.1.branches.1.1.bn1.weight",
            "backbone.stage3.0.fuse_layers.0.2.0.weight",   # up: conv, bn
            "backbone.stage3.0.fuse_layers.0.2.1.bias",
            "backbone.stage4.1.fuse_layers.3.0.2.0.weight",  # down: 3 convs
            "backbone.stage4.1.fuse_layers.3.0.1.1.weight",
            "neck.reduction_conv.conv.bias",
            "neck.fpn_convs.4.conv.weight"} <= set(sd)
    # the same widths, so no transition conv
    assert not any(k.startswith("backbone.transition2.0.") for k in sd)
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
        for (pa, a), (pb, b) in zip(
                sorted(jax.tree_util.tree_leaves_with_path(back[col]),
                       key=lambda e: jax.tree_util.keystr(e[0])),
                sorted(jax.tree_util.tree_leaves_with_path(var[col]),
                       key=lambda e: jax.tree_util.keystr(e[0]))):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    again = flax_to_state_dict(back)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_HRNET_FASTER))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


@pytest.mark.parametrize("frozen_stages", [-1, 1])
def test_the_frozen_set_is_jax_mask(frozen_stages):
    _, var, _ = pair(TINY_HRNET_FASTER)
    want = U._as_bool(j_frozen_mask(var["params"], frozen_stages))
    cfg = copy.deepcopy(TINY_HRNET_FASTER)
    cfg["backbone"]["frozen_stages"] = frozen_stages
    port = build_detector(cfg)
    assert U.frozen_tree(port) == want
    mask = frozen_backbone_mask(port, frozen_stages)
    assert mask == {k: not p.requires_grad for k, p in port.named_parameters()}
    frozen = sorted({k.split(".")[1] for k, v in mask.items() if v})
    assert frozen == ([] if frozen_stages < 0 else ["bn1", "conv1", "layer1"])


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/hrnet/*.py")))
def test_the_hrnet_configs_build(config):
    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    hrnet = model["backbone"]["type"] == "HRNet"
    assert (type(det.backbone).__name__ == "HRNet") == hrnet
    assert (type(det.neck).__name__ == "HRFPN") == hrnet
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]
