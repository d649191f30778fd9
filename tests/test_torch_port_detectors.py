"""The port's DetectoRS parts against the JAX package.

Seeded numpy inputs through each JAX module and its port, f32:

- ``SAConv`` at stride 1 and 2, with groups 1 and 32 (the ResNeXt form):
  1e-5 of the largest magnitude;
- ``RFPBottleneck`` with a SAC, a stride and an RFP feature, and without;
  ``ASPP``: 1e-5 of the largest magnitude;
- the port's frozen set of a DetectoRS detector against
  ``frozen_backbone_mask`` on the JAX package's own parameter tree (both
  empty: the JAX backbone's names are not the ResNet rule's, and neither
  backbone takes ``frozen_stages``);
- the weight bridge both ways on ``synthetic_data.TINY_DETECTORS_FASTER``
  (DetectoRS on ``TINY_FASTER_RCNN``'s RPN and RoI head; its two
  backbones keep depth 50, the only depths the JAX package has; the RFP
  neck 32 wide), and a ``.pth`` whose SAC holds mmcv's ConvAWS buffers or
  deformable offsets refused naming them;
- every config of ``configs/detectors/`` built on the meta device, with the
  JAX package's parameter counts for four;
- slow (the two ResNet-50s of every DetectoRS, eager JAX): the levels after
  the RFP neck (1e-5 of the largest magnitude), the whole predict (labels
  and valid equal, dets within 1e-4 plus 1e-5 of their magnitude) and the
  whole loss with JAX's draws (1e-5 relative) of DetectoRS on Faster
  R-CNN; DetectoRS-HTC's predict (its masks too) on the same backbone;
  an mmdet-keyed ``.pth`` loaded, ``single_device_test``,
  ``inference_detector`` and both CLIs on the tiny DetectoRS.
"""

import copy
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models.backbones import detectors_resnet as j_dr
from dsl_tpu.models.detectors.single_stage import detector_predict as j_predict
from dsl_tpu.models.necks import rfp as j_rfp
from dsl_tpu.train.optim import frozen_backbone_mask as j_frozen_mask
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.backbones import detectors_resnet
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.detectors.single_stage import (
    detector_loss, detector_predict)
from dsl_tpu_torch.models.necks import rfp
from dsl_tpu_torch.train.optim import frozen_backbone_mask
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_DETECTORS_FASTER, TINY_HTC, coco_instance_config)
from test_torch_port_cascade import HW, B, detector_pair, rel_err, t
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _val_dataset, coco, mask_batch)

torch.set_num_threads(2)

# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"detectors/cascade_rcnn_r50_sac_1x_coco.py": 84023643,
           "detectors/detectors_htc_r50_1x_coco.py": 133352272,
           "detectors/detectors_faster_rcnn_r50_coco.py": 94847035,
           "detectors/detectors_cascade_rcnn_r50_1x_coco.py": 122488745}


def _module_pair(jmodule, torch_module, inputs, flax_path: str,
                 torch_prefix: str, seed: int):
    """A JAX module's seeded variables (traced on ``inputs``) carried into
    the port's module through the weight bridge: placed at ``flax_path``
    of a detector's tree, whose port names start with ``torch_prefix``."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *inputs)
    var = fill_variables(U._plain(shapes), seed)

    def nest(tree):
        for key in reversed(flax_path.split(".")):
            tree = {key: tree}
        return tree

    sd = flax_to_state_dict({"params": nest(var["params"]),
                             "batch_stats": nest(var.get("batch_stats", {}))})
    assert all(k.startswith(torch_prefix) for k in sd)
    torch_module.load_state_dict({k[len(torch_prefix):]: v
                                  for k, v in sd.items()})
    return var, torch_module


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (1, 32), (2, 32)])
def test_saconv_matches_jax(stride, groups):
    x = np.random.RandomState(stride + groups).randn(2, 9, 11, 64).astype(
        np.float32)
    jconv = j_dr.SAConv(64, stride=stride, groups=groups)
    var, conv = _module_pair(jconv, detectors_resnet.SAConv(64, 64, stride,
                                                            groups),
                             [jnp.asarray(x)], "backbone.stages_1_0.conv2",
                             "backbone.layer2.0.conv2.", stride * groups)
    want = jax.jit(jconv.apply)(var, jnp.asarray(x))
    got = conv(U.nchw(x))
    assert tuple(got.shape[2:]) == tuple(want.shape[1:3])
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


@pytest.mark.parametrize("sac", [True, False])
def test_rfp_bottleneck_matches_jax(sac):
    rng = np.random.RandomState(3 + sac)
    x = rng.randn(2, 10, 14, 32).astype(np.float32)
    stride = 2 if sac else 1
    feat = rng.randn(2, 5 if sac else 10, 7 if sac else 14, 8).astype(
        np.float32)
    jblock = j_dr.RFPBottleneck(planes=16, stride=stride, with_sac=sac,
                                rfp_in=True, rfp_channels=8)
    block = detectors_resnet.RFPBottleneck(32, 16, stride, with_sac=sac,
                                           rfp_inplanes=8)
    var, block = _module_pair(jblock, block, [jnp.asarray(x)],
                              "backbone.stages_1_0", "backbone.layer2.0.",
                              5 + sac)
    assert float(block.rfp_conv.weight.detach().abs().sum()) > 0
    for rfp_feat in (feat, None):
        want = jax.jit(jblock.apply)(
            var, jnp.asarray(x),
            None if rfp_feat is None else jnp.asarray(rfp_feat))
        got = block(U.nchw(x), None if rfp_feat is None else U.nchw(rfp_feat))
        assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


def test_aspp_matches_jax():
    x = np.random.RandomState(7).randn(2, 9, 13, 16).astype(np.float32)
    jaspp = j_rfp.ASPP(8, (1, 3, 6, 1))
    var, aspp = _module_pair(jaspp, rfp.ASPP(16, 8), [jnp.asarray(x)],
                             "neck.rfp_aspp", "neck.rfp_aspp.", 8)
    want = jax.jit(jaspp.apply)(var, jnp.asarray(x))
    got = aspp(U.nchw(x))
    assert tuple(got.shape) == (2, 32, 9, 13)
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX package's TINY_DETECTORS_FASTER: its detector and its
    variables' shapes."""
    from dsl_tpu.models import build_detector as j_build
    from dsl_tpu.models.detectors.single_stage import init_detector_variables

    det = j_build(copy.deepcopy(TINY_DETECTORS_FASTER))
    return det, U._plain(jax.eval_shape(
        lambda r, x: init_detector_variables(det, r, x),
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))


def test_the_frozen_set_is_jax_mask(jax_tree):
    frozen_stages = TINY_DETECTORS_FASTER["backbone"].get("frozen_stages", -1)
    want = [jax.tree_util.keystr(p) for p, v in
            jax.tree_util.tree_leaves_with_path(
                j_frozen_mask(jax_tree[1]["params"], frozen_stages)) if v]
    port = build_detector(copy.deepcopy(TINY_DETECTORS_FASTER))
    got = [k for k, v in frozen_backbone_mask(port, frozen_stages).items() if v]
    got += [k for k, p in port.named_parameters() if not p.requires_grad]
    assert want == [] and got == []
    # neither package's DetectoRS backbone takes frozen_stages
    cfg = copy.deepcopy(TINY_DETECTORS_FASTER)
    cfg["backbone"]["frozen_stages"] = 1
    with pytest.raises(TypeError, match="frozen_stages"):
        build_detector(cfg)


def test_bridge_round_trip_and_refused_sac_keys(jax_tree, tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    var = fill_variables(jax_tree[1], 0)
    port = build_detector(copy.deepcopy(TINY_DETECTORS_FASTER))
    port.load_state_dict(flax_to_state_dict(var))
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        for part in ("backbone", "neck"):
            assert sorted(back[col][part]) == sorted(var[col][part])
    sac = var["params"]["neck"]["rfp_modules_0"]["stages_2_0"]["conv2"]
    for leaf in ("weight", "weight_diff"):
        np.testing.assert_array_equal(
            back["params"]["neck"]["rfp_modules_0"]["stages_2_0"]["conv2"][leaf],
            sac[leaf])
    again = flax_to_state_dict(back)
    assert sorted(again) == sorted(k for k in sd
                                   if not k.endswith("num_batches_tracked"))
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    assert {"backbone.conv1.weight", "backbone.layer2.0.conv2.weight_diff",
            "backbone.layer2.0.conv2.switch.bias",
            "backbone.layer3.1.conv2.pre_context.weight",
            "backbone.layer4.0.conv2.post_context.bias",
            "backbone.layer2.0.rfp_conv.weight",
            "neck.rfp_modules.0.layer3.0.rfp_conv.bias",
            "neck.rfp_aspp.aspp.3.weight", "neck.rfp_weight.weight",
            "neck.lateral_convs.0.conv.weight"} <= set(sd)
    assert "backbone.layer1.0.conv2.weight_diff" not in sd     # no SAC there
    # mmcv's SAConv2d: weight standardisation buffers, deformable offsets
    path = tmp_path / "mmcv_sac.pth"
    extra = {f"backbone.layer3.2.conv2.{k}": torch.zeros(1) for k in
             ("weight_gamma", "weight_beta", "offset_s.weight")}
    torch.save({"state_dict": dict(
        extra, **{k: sd[k] for k in ("backbone.conv1.weight",
                                     "backbone.layer3.2.conv2.weight")})},
        path)
    for load in (load_weights, load_torch_detector):
        with pytest.raises(KeyError, match="weight_beta.*weight_gamma"):
            load(str(path), port)


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/detectors/*.py")))
def test_the_detectors_configs_build(config):
    from dsl_tpu_torch.config import Config

    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    want = ("HTC" if "htc" in config else "CascadeRCNN" if "cascade" in config
            else "DetectoRS")
    assert type(det).__name__ == want
    assert type(det.backbone).__name__.startswith("DetectoRSResNe")
    assert (type(det.neck).__name__ == "RFP") == (model["neck"]["type"] == "RFP")
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


# -- slow: whole detectors (two ResNet-50s each) ---------------------------------

@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_DETECTORS_FASTER)


@pytest.mark.slow
def test_levels_after_the_rfp_neck_match_jax(pair):
    det, var, port = pair
    x = U.images(4, B, HW)
    want = det.apply(var, jnp.asarray(x))[0]
    with torch.no_grad():
        got = port(U.nchw(x))[0]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert rel_err(g.permute(0, 2, 3, 1), w) < 1e-5


@pytest.mark.slow
def test_detectors_predict_and_loss_match_jax(pair, monkeypatch):
    from dsl_tpu.models.detectors.single_stage import detector_loss as j_loss
    from test_torch_port_two_stage import jax_draws

    det, var, port = pair
    x = U.images(3, B, HW)
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    want = j_predict(det, var, jnp.asarray(x), img_shapes=jnp.asarray(shapes),
                     scale_factors=jnp.asarray(sfs))
    got = detector_predict(port, U.nchw(x), img_shapes=t(shapes),
                           scale_factors=t(sfs), device="cpu")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    assert int(got[2].sum()) > 20
    batch = mask_batch(12)
    batch["images"] = U.images(12, B, HW)
    wl = jax.jit(lambda v, b_: j_loss(det, v, b_, cur_iter=5)[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(two_stage, "sampler_draws",
                        lambda it, b, a, n, dev, stages=1: jax_draws(it, b, a, n))
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, gl = detector_loss(copy.deepcopy(port).train(), pb, cur_iter=5)
    assert set(gl) == set(wl)
    for k, v in wl.items():
        assert abs(float(gl[k]) - float(v)) <= 1e-5 * max(abs(float(v)),
                                                          1e-3), k


@pytest.mark.slow
def test_detectors_htc_predict_matches_jax():
    from dsl_tpu.models.detectors import cascade_rcnn as j_cas
    from dsl_tpu_torch.models.detectors import cascade_rcnn
    from test_torch_port_htc import predict_against_jax

    cfg = dict(copy.deepcopy(TINY_HTC), type="DetectoRS",
               backbone=TINY_DETECTORS_FASTER["backbone"],
               neck=TINY_DETECTORS_FASTER["neck"])
    pair = detector_pair(cfg)
    assert type(pair[2]).__name__ == "HTC"
    predict_against_jax(pair, j_cas.htc_predict, cascade_rcnn.htc_predict)


@pytest.mark.slow
def test_entry_points_on_tiny_coco(coco, tmp_path):
    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli
    from dsl_tpu_torch.tools import train as train_cli
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    cfg = copy.deepcopy(TINY_DETECTORS_FASTER)
    cfg["bbox_head"]["num_classes"] = 80
    port = detector_pair(cfg)[2]
    # an mmdet-keyed checkpoint of the same layout loads
    pth = tmp_path / "mmdet.pth"
    sd = port.state_dict()
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, pth)
    fresh = build_detector(copy.deepcopy(cfg))
    missing, unexpected = load_torch_detector(str(pth), fresh)
    assert not missing and not unexpected
    metrics = single_device_test(
        port, None, _val_dataset(coco), canvas_hw=HW,
        img_scale=(96, 64), device="cpu")
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0
    raw = coco_instance_config(Config.fromfile(
        "configs/detectors/detectors_faster_rcnn_r50_coco.py").to_dict(), coco)
    raw["model"] = cfg
    raw["canvas_hw"] = list(HW)
    for step in raw["data"]["train"]["pipeline"]:
        if step["type"] == "Resize":
            step["img_scale"] = (96, 64)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    raw["data"]["workers_per_gpu"] = 1
    raw.update(runner=dict(type="EpochBasedRunner", max_epochs=1),
               log_config=dict(interval=1), evaluation=dict(interval=1))
    path = str(tmp_path / "tiny_detectors.py")
    Config(raw).dump(path)
    work = tmp_path / "work"
    train_cli.main([path, "--work-dir", str(work), "--device", "cpu"])
    log = [json.loads(x) for x in (work / "train.log.json").read_text()
           .splitlines()]
    steps = [x for x in log if x.get("mode") == "train"]
    assert steps and all(np.isfinite(x["loss"]) for x in steps)
    ckpt = str(work / "epoch_1.pth")
    _, metrics = test_cli.main([path, ckpt, "--eval", "bbox", "--device",
                                "cpu"])
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0
    bundle = init_detector(path, ckpt, device="cpu")
    name = _val_dataset(coco).data_infos[0]["filename"]
    assert len(inference_detector(bundle, coco["val_images"] + name)) == 80
