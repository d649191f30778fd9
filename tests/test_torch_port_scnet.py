"""The port's SCNet and its heads against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_SCNET`` (``TINY_CASCADE_RCNN``'s backbone, FPN and
RPN; three class-specific 32-wide ``SCNetBBoxHead``s, a one-block
``SCNetMaskHead``, ``TINY_HTC``'s semantic head, a one-block
``GlobalContextHead`` and a 64-to-32 ``FeatureRelayHead``; 20 classes),
f32:

- each stage's ``SCNetBBoxHead`` with its shared features, the relay head
  (the (c, s, s) map the bridge's row permutation gives and the 7 -> 14
  enlargement), the global-context head, the mask head: 1e-5 of the
  largest magnitude; a ``GlobalContextHead`` whose blocks change the width
  (their 1x1 ``shortcut``) and its plain-conv form alike;
- ``global_context_loss``: 1e-6 relative;
- ``decode_stage`` on an SCNet head without labels (the class mean of the
  per-class deltas, the refinement between stages) and at labels: boxes
  within 1e-4 plus 1e-6 of their magnitude;
- the loss's keys (one ``loss_mask``, ``loss_glbctx``, no ``acc``) and its
  gradients (the mask loss reaches the relay head and the last box head);
- the weight bridge both ways (the relay FC's rows) and an mmdet-keyed
  ``.pth`` loaded;
- every config of ``configs/scnet/`` built on the meta device, with the
  JAX package's parameter counts for two;
- slow: ``single_device_test`` on the tiny SCNet gives boxes,
  ``inference_detector`` and the test CLI (HTC's file runs these
  untagged); per stage, on random levels and context and JAX's proposals of
  that stage, the samples given JAX's uniforms, which JAX draws for SCNet
  from a 4-way split of its key (equal), the stage losses (1e-5 relative)
  and the refinement, then the mask branch on the last stage's samples
  (JAX's targets handed to both, 1e-5 relative) (14 s, one compile); the
  whole predict (labels and valid equal, dets within 1e-4 plus 1e-5 of
  their magnitude, probabilities 1e-5) and the whole loss with JAX's
  draws (1e-5 relative, ``loss_mask`` 1e-3 for target ties) against
  JAX's, and one epoch of the train CLI.
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
from dsl_tpu.models.detectors import cascade_rcnn as j_cas
from dsl_tpu.models.roi_heads import mask_head as j_mask
from dsl_tpu.models.roi_heads import scnet as j_scnet
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors import cascade_rcnn, two_stage
from dsl_tpu_torch.models.roi_heads import scnet
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.models.roi_heads.mask_head import mask_head_loss
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import TINY_SCNET, coco_instance_config
from test_torch_port_cascade import (
    B, HW, P, SAMPLES, _levels, assert_boxes_close, detector_pair, rel_err,
    random_boxes, t)
from test_torch_port_htc import (
    jax_split_draws, loss_against_jax, near_gt_proposals, predict_against_jax)
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _val_dataset, coco, mask_batch)

torch.set_num_threads(2)

# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"scnet/scnet_r50_fpn_1x_coco.py": 95775065,
           "scnet/scnet_x101_64x4d_fpn_20e_coco.py": 153673305}


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_SCNET)


def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for head in cfg["bbox_heads"] + [cfg["mask_head"], cfg["glbctx_head"]]:
        head["num_classes"] = 80
    cfg["semantic_head"]["num_classes"] = 84
    return cfg


@pytest.fixture(scope="module")
def pair80():
    return detector_pair(coco80(TINY_SCNET))


# -- the heads -------------------------------------------------------------------

@pytest.mark.parametrize("stage", range(3))
def test_bbox_heads_and_shared_features_match_jax(pair, stage):
    det, var, port = pair
    x = np.random.RandomState(stage).randn(6, 7, 7, 32).astype(np.float32)
    want = det.apply(var, jnp.asarray(x), stage, True,
                     method=det.roi_forward)
    got = port(U.nchw(x), stage="roi", head=stage, shared=True)
    assert [tuple(g.shape) for g in got] == [(6, 21), (6, 80), (6, 64)]
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-5
    assert len(port(U.nchw(x), stage="roi", head=stage)) == 2


def test_relay_and_mask_heads_match_jax(pair):
    det, var, port = pair
    rng = np.random.RandomState(7)
    fc = rng.randn(6, 64).astype(np.float32)
    want = jax.jit(lambda v, x_: det.apply(v, x_, method=det.relay_forward))(
        var, jnp.asarray(fc))
    got = port(torch.from_numpy(fc), stage="relay")
    assert tuple(got.shape) == (6, 32, 14, 14)
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5
    mf = rng.randn(6, 14, 14, 32).astype(np.float32)
    want = jax.jit(lambda v, x_: det.apply(v, x_, method=det.mask_forward))(
        var, jnp.asarray(mf))
    got = port(U.nchw(mf), stage="mask")
    assert tuple(got.shape) == (6, 20, 28, 28)
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


def test_global_context_head_matches_jax(pair):
    det, var, port = pair
    jfeats, pfeats = _levels(pair, 8)
    want = jax.jit(lambda v, f: det.apply(v, f, method=det.glbctx_forward))(
        var, jfeats)
    got = port(pfeats, stage="glbctx")
    assert [tuple(g.shape) for g in got] == [(B, 20), (B, 32)]
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-5


@pytest.mark.parametrize("conv_to_res", [True, False])
def test_a_widening_global_context_head_matches_jax(conv_to_res):
    """16 channels in, 32 out: the first block's 1x1 shortcut (or the
    plain convs), FrozenBN statistics filled."""
    kw = dict(num_convs=4, in_channels=16, conv_out_channels=32,
              num_classes=5, conv_to_res=conv_to_res)
    jhead = j_scnet.GlobalContextHead(**kw)
    x = np.random.RandomState(9).randn(2, 5, 7, 16).astype(np.float32)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            [jnp.zeros((1, 5, 7, 16))])
    var = fill_variables(U._plain(shapes), 10)
    want = jax.jit(jhead.apply)(var, [jnp.asarray(x)])
    head = scnet.GlobalContextHead(**kw)
    sd = flax_to_state_dict({"params": {"glbctx_head": var["params"]},
                             "batch_stats": {"glbctx_head":
                                             var.get("batch_stats", {})}})
    prefix = "roi_head.glbctx_head."
    head.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    if conv_to_res:
        assert head.convs[0].shortcut is not None
        assert head.convs[1].shortcut is None
    got = head([U.nchw(x)])
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-5


def test_global_context_loss_matches_jax():
    rng = np.random.RandomState(11)
    logits = rng.randn(3, 20).astype(np.float32)
    labels = rng.randint(0, 25, (3, 6))               # past the classes too
    valid = (rng.rand(3, 6) < 0.7).astype(np.float32)
    want = jax.jit(lambda a, b_, c: j_scnet.global_context_loss(
        a, b_, c, 20, loss_weight=3.0))(jnp.asarray(logits),
                                        jnp.asarray(labels), jnp.asarray(valid))
    got = scnet.global_context_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(valid), 20,
                                    loss_weight=3.0)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("labels", [False, True])
def test_decode_stage_on_a_class_specific_head_matches_jax(pair, labels):
    det, _, port = pair
    rng = np.random.RandomState(12)
    props = random_boxes(rng, (B, 40))
    reg = rng.randn(B * 40, 80).astype(np.float32)
    lab = rng.randint(0, 20, (B, 40)) if labels else None
    assert not port.bbox_heads[1].reg_class_agnostic
    want = jax.jit(lambda p_, r_, l_: j_cas._decode_stage(
        det.bbox_heads[1], p_, r_, l_))(
        jnp.asarray(props), jnp.asarray(reg),
        None if lab is None else jnp.asarray(lab))
    got = cascade_rcnn.decode_stage(port.bbox_heads[1], t(props), t(reg),
                                    None if lab is None else t(lab))
    assert_boxes_close(got, want)


# -- the loss, the bridge and the builds -----------------------------------------

def test_scnet_loss_keys_and_gradients(pair, monkeypatch):
    from dsl_tpu_torch.models.detectors import single_stage

    port = copy.deepcopy(pair[2]).train()
    batch = {k: t(v, torch.int64 if k == "gt_labels" else None)
             for k, v in mask_batch(13).items()}
    batch["images"] = U.nchw(U.images(13, B, HW))
    losses = {}
    real = single_stage._parse_losses
    monkeypatch.setattr(single_stage, "_parse_losses",
                        lambda d: (losses.update(d), real(d))[1])
    _, log_vars = single_stage.detector_loss(port, batch, cur_iter=2)
    assert set(log_vars) == ({"loss_rpn_cls", "loss_rpn_bbox", "loss_mask",
                              "loss_semantic_seg", "loss_glbctx", "loss"}
                             | {f"s{i}.{k}" for i in range(3)
                                for k in ("loss_cls", "loss_bbox")})
    assert all(bool(torch.isfinite(v)) for v in log_vars.values())

    def moved(module):
        return any(p.grad is not None and bool(p.grad.abs().sum() > 0)
                   for p in module.parameters())

    losses["loss_mask"].backward(retain_graph=True)
    assert moved(port.relay_head) and moved(port.bbox_heads[2])
    assert moved(port.glbctx_head) and moved(port.semantic_head)
    assert not moved(port.bbox_heads[0])
    port.zero_grad()
    losses["loss_glbctx"].backward(retain_graph=True)
    assert moved(port.glbctx_head) and not moved(port.mask_head)


def test_bridge_round_trip_and_mmdet_pth(pair, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(back["params"]["relay_head"]["fc"][leaf],
                                      var["params"]["relay_head"]["fc"][leaf])
    again = flax_to_state_dict(back)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    # the relay FC's rows: (c, h, w) here, (h, w, c) in the JAX package
    kernel = var["params"]["relay_head"]["fc"]["kernel"]        # (in, h*w*c)
    w = sd["roi_head.feat_relay_head.fc.weight"]                 # (c*h*w, in)
    np.testing.assert_array_equal(
        w.reshape(32, 7, 7, 64).permute(1, 2, 0, 3).reshape(-1, 64).numpy(),
        kernel.T)
    assert {"roi_head.glbctx_head.convs.0.conv1.weight",
            "roi_head.glbctx_head.convs.0.bn2.running_var",
            "roi_head.glbctx_head.fc.weight",
            "roi_head.mask_head.convs.0.conv2.weight",
            "roi_head.mask_head.upsample.weight",
            "roi_head.semantic_head.conv_logits.bias",
            "roi_head.bbox_head.2.shared_fcs.0.weight"} <= set(sd)
    assert tuple(sd["roi_head.bbox_head.0.fc_reg.weight"].shape) == (80, 64)
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_SCNET))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/scnet/*.py")))
def test_the_scnet_configs_build(config):
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ == "SCNet" and len(det.bbox_heads) == 3
    assert not any(h.reg_class_agnostic for h in det.bbox_heads)
    assert det.glbctx_head.loss_weight == 3.0
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


# -- the entry points on a tiny COCO instance set ---------------------------------

@pytest.mark.slow
def test_single_device_test_inference_and_the_test_cli(coco, pair80, tmp_path):
    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    test_cfg = dict(rcnn=dict(TINY_SCNET["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    metrics, results = single_device_test(
        pair80[2], None, _val_dataset(coco), test_cfg=test_cfg, canvas_hw=HW,
        img_scale=(96, 64), device="cpu", return_results=True)
    assert "bbox_mAP" in metrics and "segm_mAP" not in metrics
    assert all(len(r) == 2 and len(r[0]) > 0 for r in results)
    cfg = Config.fromfile("configs/scnet/scnet_r50_fpn_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_SCNET)
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_scnet.py")
    Config(raw).dump(path)
    ckpt = str(tmp_path / "seeded.pth")
    torch.save(pair80[2].state_dict(), ckpt)
    _, metrics = test_cli.main([path, ckpt, "--eval", "bbox", "--device",
                                "cpu"])
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0
    bundle = init_detector(path, ckpt, device="cpu")
    name = _val_dataset(coco).data_infos[0]["filename"]
    per_class = inference_detector(bundle, coco["val_images"] + name)
    assert len(per_class) == 80 and sum(len(c) for c in per_class) > 0


# -- slow: the stages, whole-detector comparisons and an epoch -----------------

def _jax_scnet_stages(det, var, feats, sem, glb, props, pvalid, batch, rng):
    """JAX's SCNet loss as ``scnet_loss`` runs it on the given levels,
    semantic embedding and pooled context: per stage the proposals,
    uniforms (from ``split(rng, 4)``), samples, losses and refinement, and
    the mask branch's loss on the last stage's samples."""
    keys = jax.random.split(rng, len(det.bbox_heads) + 1)
    strides = tuple(det.rpn_head.strides)[:4]
    out = []
    for stage, head in enumerate(det.bbox_heads):
        kw = j_cas._stage_rcnn_kw(det, stage, SAMPLES)
        samples = j_roi.sample_batch_rois(props, pvalid, batch, keys[stage],
                                          head.num_classes, **kw)
        uniforms = jnp.stack([jax.random.uniform(k, (props.shape[1] + 6,))
                              for k in jax.random.split(keys[stage], B)])
        idx = jnp.repeat(jnp.arange(B, dtype=jnp.float32), SAMPLES)[:, None]
        flat = jnp.concatenate([idx, samples["rois"].reshape(-1, 4)], 1)
        valid = samples["valid"].reshape(-1)
        rf = j_cas._scnet_fuse(j_roi.extract_roi_feats(
            feats, flat, valid, strides, 7), sem, glb, flat, valid, 7)
        losses = j_roi.rcnn_bbox_loss(
            head, *det.apply(var, rf, stage, method=det.roi_forward), samples,
            batch)
        aflat = jnp.concatenate([jnp.repeat(jnp.arange(B, dtype=jnp.float32),
                                            props.shape[1])[:, None],
                                 props.reshape(-1, 4)], 1)
        av = pvalid.reshape(-1)
        rf = j_cas._scnet_fuse(j_roi.extract_roi_feats(
            feats, aflat, av, strides, 7), sem, glb, aflat, av, 7)
        refined = j_cas._decode_stage(
            head, props, det.apply(var, rf, stage, method=det.roi_forward)[1])
        out.append(dict(props=props, uniforms=uniforms, samples=samples,
                        losses=losses, refined=refined))
        props = refined
    samples = out[-1]["samples"]
    prois, plabels, passigned, ppos = j_mask.select_positive_rois(
        samples["rois"], samples["labels"], samples["assigned"],
        samples["is_pos"], SAMPLES // 4)
    pidx = jnp.repeat(jnp.arange(B), SAMPLES // 4)
    pflat = jnp.concatenate([pidx[:, None].astype(jnp.float32),
                             prois.reshape(-1, 4)], 1)
    pv = ppos.reshape(-1)
    mf = j_cas._scnet_fuse(j_roi.extract_roi_feats(feats, pflat, pv, strides,
                                                   14), sem, glb, pflat, pv, 14)
    bf = j_cas._scnet_fuse(j_roi.extract_roi_feats(feats, pflat, pv, strides,
                                                   7), sem, glb, pflat, pv, 7)
    shared = det.apply(var, bf, 2, True, method=det.roi_forward)[2]
    logits = det.apply(var, mf + det.apply(var, shared,
                                           method=det.relay_forward),
                       method=det.mask_forward)
    targets = j_mask.mask_targets_from_crops(
        batch["gt_mask_crops"], batch["gt_bboxes"], prois.reshape(-1, 4),
        pidx, passigned.reshape(-1), mask_size=28)
    loss_mask = j_mask.mask_head_loss(logits, targets, plabels.reshape(-1),
                                      pv.astype(jnp.float32), 20)
    return out, loss_mask


@pytest.mark.slow
def test_scnet_stage_losses_match_jax_given_its_samples(pair, monkeypatch):
    det, var, port = pair
    jfeats, pfeats = _levels(pair, 14)
    rng = np.random.RandomState(15)
    sem = rng.randn(B, 8, 12, 32).astype(np.float32)
    glb = rng.randn(B, 32).astype(np.float32)
    batch = mask_batch(16)
    props = near_gt_proposals(batch, 17)
    pvalid = np.ones((B, P), bool)
    pvalid[0, -5:] = False
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_mask = jax.jit(lambda v, f, s, g, p, pv, b_: _jax_scnet_stages(
        det, v, f, s, g, p, pv, b_, jax.random.PRNGKey(18)))(
        var, jfeats, jnp.asarray(sem), jnp.asarray(glb), jnp.asarray(props),
        jnp.asarray(pvalid), jb)
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    fuse = cascade_rcnn._scnet_fuser(U.nchw(sem), torch.from_numpy(glb))
    samples = None
    for stage, w in enumerate(want):
        head = port.bbox_heads[stage]
        samples = roi.sample_batch_rois(
            t(w["props"]), t(pvalid), pb, t(w["uniforms"]), 20,
            **cascade_rcnn.stage_rcnn_kw(port, stage))
        for k, v in w["samples"].items():
            np.testing.assert_array_equal(samples[k].numpy(), np.asarray(v),
                                          err_msg=f"stage {stage} {k}")
        assert int(samples["is_pos"].sum()) > 8, stage
        rois, valid = roi.flat_rois(samples["rois"]), samples["valid"].reshape(-1)
        rf = fuse(roi.extract_roi_feats(pfeats, rois, valid, port.strides, 7),
                  rois, valid, 7)
        got = roi.rcnn_bbox_loss(head, *port(rf, stage="roi", head=stage),
                                 samples, pb)
        for k, v in w["losses"].items():
            assert abs(float(got[k].detach()) - float(v)) <= 1e-5 * max(
                abs(float(v)), 1e-6), (stage, k)
        with torch.no_grad():
            rois, valid = roi.flat_rois(t(w["props"])), t(pvalid).reshape(-1)
            rf = fuse(roi.extract_roi_feats(pfeats, rois, valid, port.strides,
                                            7), rois, valid, 7)
            refined = cascade_rcnn.decode_stage(
                head, t(w["props"]), port(rf, stage="roi", head=stage)[1])
        assert_boxes_close(refined, w["refined"], rtol=1e-5)
    prois, plabels, passigned, ppos = cascade_rcnn._mask_rois(samples,
                                                              SAMPLES // 4)
    logits = cascade_rcnn._scnet_mask_logits(port, port, pfeats, fuse, prois,
                                             ppos)
    got = mask_head_loss(logits, cascade_rcnn._mask_targets(
        pb, prois, passigned, 28), plabels, ppos.to(torch.float32), 20)
    assert abs(float(got) - float(want_mask)) <= 1e-5 * float(want_mask)


@pytest.mark.slow
def test_scnet_predict_matches_jax(pair):
    predict_against_jax(pair, j_cas.scnet_predict, cascade_rcnn.scnet_predict)


@pytest.mark.slow
def test_scnet_loss_matches_jax_banded(pair, monkeypatch):
    loss_against_jax(pair, j_cas.scnet_loss, cascade_rcnn.scnet_loss, 4,
                     monkeypatch)


@pytest.mark.slow
def test_train_cli_on_tiny_coco(coco, tmp_path):
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import train as train_cli
    from test_torch_port_htc import SEG_PIPELINE

    cfg = Config.fromfile("configs/scnet/scnet_r50_fpn_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_SCNET)
    raw["canvas_hw"] = list(HW)
    pipe = copy.deepcopy(SEG_PIPELINE)
    for step in pipe:
        if step["type"] == "Resize":
            step.update(img_scale=(96, 64), multiscale_mode="range")
    raw["data"]["train"]["pipeline"] = pipe
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    raw["data"]["workers_per_gpu"] = 1
    raw.update(runner=dict(type="EpochBasedRunner", max_epochs=1),
               log_config=dict(interval=1), evaluation=dict(interval=1))
    path = str(tmp_path / "tiny_scnet_train.py")
    Config(raw).dump(path)
    work = tmp_path / "work"
    train_cli.main([path, "--work-dir", str(work), "--device", "cpu"])
    log = [json.loads(x) for x in (work / "train.log.json").read_text()
           .splitlines()]
    steps = [x for x in log if x.get("mode") == "train"]
    assert steps and all(np.isfinite(x[k]) for x in steps
                         for k in ("loss_mask", "loss_glbctx"))
    val = [x for x in log if x.get("mode") == "val"]
    assert val and 0.0 <= val[-1]["bbox_mAP"] <= 1.0


def test_jax_split_draws_stand_in_is_four_way():
    """The stand-in's stage draws are JAX's ``split(rng, 4)[i]``, SCNet's.
    Under the installed JAX's partitionable threefry ``split(rng, n)[i]``
    does not depend on ``n``, so they are the cascade's 3-way ones too."""
    four = jax_split_draws(4)(3, B, 10, 8, "cpu", stages=3)
    three = jax_split_draws(3)(3, B, 10, 8, "cpu", stages=3)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(3, jnp.uint32))
    for i, key in enumerate(jax.random.split(rng, 4)[:3]):
        want = jnp.stack([jax.random.uniform(k, (8,))
                          for k in jax.random.split(key, B)])
        np.testing.assert_array_equal(four["rcnn"][i].numpy(),
                                      np.asarray(want))
        assert torch.equal(four["rcnn"][i], three["rcnn"][i]) == bool(
            jax.config.jax_threefry_partitionable)
    assert torch.equal(four["rpn"], three["rpn"])
