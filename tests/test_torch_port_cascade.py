"""The port's Cascade R-CNN and Cascade Mask R-CNN against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_CASCADE_MASK_RCNN`` (``TINY_FASTER_RCNN``'s parts,
three 64-wide class-agnostic stages, ``TINY_MASK_RCNN``'s mask head; 20
classes), f32:

- each stage's class-agnostic head: 1e-5 of the largest magnitude;
- ``decode_stage`` (class-agnostic, the class mean, at labels): boxes
  within 1e-4 plus 1e-6 of their magnitude;
- ``cascade_decode_nms`` on the same stage outputs, the plain NMS on the
  CPU: labels and valid equal, dets within 1e-4 plus 1e-5 of their
  magnitude;
- per stage, on random FPN levels and JAX's proposals of that stage: the
  sampler fed JAX's per-stage uniforms gives JAX's samples (equal), the
  RoI head's losses on them 1e-5 relative, the shared mask head's
  ``loss_mask`` on them (JAX's targets handed to both, as in the Mask
  R-CNN file) 1e-5 relative, and the refinement to the next stage's
  proposals as the boxes above;
- ``stage_rcnn_kw`` for a list, a single and no ``train_cfg.rcnn``: equal;
- the loss's keys, its stage weights and no gradient through the
  refinement; the per-stage draws;
- the weight bridge both ways, an mmdet-keyed ``.pth`` loaded, and one with
  mmdet's three mask heads refused naming their keys;
- every config of ``configs/cascade_rcnn/`` built on the meta device, with
  the JAX package's parameter counts for four; Sparse R-CNN and a SABL
  stage refused by name (HTC, SCNet and DetectoRS are ported: their own
  files);
- ``single_device_test`` (boxes only for Cascade Mask R-CNN, as in JAX),
  ``tta_test``, ``inference_detector``, the test CLI with ``--eval bbox``
  and its refusal of ``--eval segm``, on a tiny COCO instance set;
- slow: the whole predict (labels and valid equal, dets as above) and the
  whole loss (JAX's draws passed in: 1e-5 relative, the stages'
  ``loss_mask`` 1e-3 for target ties) against JAX's (eager and compiled
  JAX, about 10-20 s each), and one epoch of the train CLI.
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
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.detectors import cascade_rcnn as j_cas
from dsl_tpu.models.detectors import two_stage as j_two
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors import cascade_rcnn, two_stage
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_CASCADE_MASK_RCNN, TINY_CASCADE_RCNN, coco_instance_config)
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _val_dataset, coco, mask_batch)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
P = 300             # proposals per image: more than the 256 samples
SAMPLES = cascade_rcnn.CASCADE_SAMPLES
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py": 69394766,
           "cascade_rcnn/cascade_rcnn_r101_caffe_fpn_1x_coco.py": 88386894,
           "cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py": 72038046,
           "cascade_rcnn/cascade_mask_rcnn_x101_32x4d_fpn_1x_coco.py":
               90658718}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def detector_pair(cfg: dict, seed: int = 0):
    """The JAX detector, its seeded variables (every stage and the mask
    head) and the port's detector with them, in eval mode."""
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda r, x: init_detector_variables(det, r, x),
                            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    var = {k: U._plain(v) for k, v in fill_variables(dict(shapes), seed).items()}
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_CASCADE_MASK_RCNN)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-12))


def random_boxes(rng, shape, h: int = HW[0], w: int = HW[1]) -> np.ndarray:
    x1, y1 = rng.uniform(-4, w - 8, shape), rng.uniform(-4, h - 8, shape)
    return np.stack([x1, y1, x1 + rng.uniform(3, 50, shape),
                     y1 + rng.uniform(3, 40, shape)], -1).astype(np.float32)


def assert_boxes_close(got: torch.Tensor, want, rtol: float = 1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("stage", range(3))
def test_stage_heads_match_jax(pair, stage):
    det, var, port = pair
    x = np.random.RandomState(stage).randn(5, 7, 7, 32).astype(np.float32)
    want = det.apply(var, jnp.asarray(x), stage, method=det.roi_forward)
    got = port(U.nchw(x), stage="roi", head=stage)
    assert tuple(got[0].shape) == (5, 21) and tuple(got[1].shape) == (5, 4)
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-5


def _class_specific_heads():
    """A class-specific stage head in both packages (the cascade's stages
    are class-agnostic)."""
    kw = dict(num_classes=20, in_channels=32, fc_channels=64,
              target_stds=(0.05, 0.05, 0.1, 0.1))
    return (j_roi.Shared2FCBBoxHead(**kw),
            roi.Shared2FCBBoxHead(**kw, reg_class_agnostic=False))


@pytest.mark.parametrize("case", ["agnostic", "class_mean", "labels"])
def test_decode_stage_matches_jax(pair, case):
    det, _, port = pair
    rng = np.random.RandomState(3)
    props = random_boxes(rng, (B, 40))
    if case == "agnostic":
        jh, ph = det.bbox_heads[1], port.bbox_heads[1]
    else:
        jh, ph = _class_specific_heads()
    reg = (rng.randn(B * 40, 4 if case == "agnostic" else 80)
           .astype(np.float32))
    labels = rng.randint(0, 20, (B, 40)) if case == "labels" else None
    want = j_cas._decode_stage(jh, jnp.asarray(props), jnp.asarray(reg),
                               None if labels is None else jnp.asarray(labels))
    got = cascade_rcnn.decode_stage(ph, t(props), t(reg),
                                    None if labels is None else t(labels))
    assert_boxes_close(got, want)


def _stage_outputs(seed: int, n: int, nc: int = 20):
    """Random raw logits (live classes well above the background) and
    class-agnostic deltas for ``n`` RoIs, per stage."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        logits = rng.randn(n, nc + 1).astype(np.float32)
        logits[:, :6] += 2.0
        out.append((logits, 0.3 * rng.randn(n, 4).astype(np.float32)))
    return out


def test_cascade_decode_nms_matches_jax(pair):
    det, _, port = pair
    rng = np.random.RandomState(4)
    props = random_boxes(rng, (B, 60))
    pvalid = rng.rand(B, 60) < 0.9
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    outs = _stage_outputs(5, B * 60)
    test_cfg = TINY_CASCADE_RCNN["test_cfg"]

    @jax.jit
    def want_fn(props, pvalid, shapes, sfs, outs):
        return j_cas.cascade_decode_nms(
            det.bbox_heads, lambda s, _: outs[s], props, pvalid,
            img_shapes=shapes, scale_factors=sfs, test_cfg=test_cfg)

    want = want_fn(*(jnp.asarray(a) for a in (props, pvalid, shapes, sfs)),
                   [tuple(jnp.asarray(a) for a in o) for o in outs])
    got = cascade_rcnn.cascade_decode_nms(
        port.bbox_heads, lambda s, _: tuple(t(a) for a in outs[s]), t(props),
        t(pvalid), img_shapes=t(shapes), scale_factors=t(sfs),
        test_cfg=test_cfg)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    assert int(got[2].sum()) > 50


def _levels(pair, seed: int):
    """Random FPN levels of the detector's shapes: JAX's NHWC list and the
    port's NCHW one."""
    with torch.no_grad():
        shapes = [f.shape for f in pair[2](torch.zeros((B, 3, *HW)))[0]]
    rng = np.random.RandomState(seed)
    levels = [rng.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(np.transpose(f, (0, 2, 3, 1))) for f in levels],
            [torch.from_numpy(f) for f in levels])


def _jax_stages(det, var, feats, props, pvalid, batch, rng):
    """JAX's cascade loss, stage by stage as ``cascade_rcnn_loss`` runs it:
    each stage's proposals, uniforms, samples, RoI head losses and (for the
    next stage) refined proposals."""
    keys = jax.random.split(rng, len(det.bbox_heads))
    strides = tuple(det.rpn_head.strides)[:4]
    out = []
    for stage, head in enumerate(det.bbox_heads):
        def roi_apply(v, rf, _s=stage):
            return det.apply(v, rf, _s, method=det.roi_forward)

        kw = j_cas._stage_rcnn_kw(det, stage, SAMPLES)
        samples = j_roi.sample_batch_rois(props, pvalid, batch, keys[stage],
                                          head.num_classes, **kw)
        uniforms = jnp.stack([jax.random.uniform(k, (props.shape[1] + 6,))
                              for k in jax.random.split(keys[stage], B)])
        losses = j_roi.roi_head_loss(head, roi_apply, var, feats, props,
                                     pvalid, batch, keys[stage],
                                     strides=strides, num_samples=SAMPLES,
                                     samples=samples)
        flat = jnp.concatenate([jnp.repeat(jnp.arange(B, dtype=jnp.float32),
                                           props.shape[1])[:, None],
                                props.reshape(-1, 4)], 1)
        rf = j_roi.extract_roi_feats(feats, flat, pvalid.reshape(-1), strides,
                                     head.roi_size)
        refined = j_cas._decode_stage(head, props, roi_apply(var, rf)[1])
        out.append(dict(props=props, uniforms=uniforms, samples=samples,
                        losses=losses, refined=refined))
        props = refined
    return out


def test_stage_losses_match_jax_given_its_samples(pair, monkeypatch):
    det, var, port = pair
    jfeats, pfeats = _levels(pair, 6)
    batch = mask_batch(7)
    rng = np.random.RandomState(8)
    props = random_boxes(rng, (B, P))
    for i in range(B):         # a third near the GT, so that every stage
        gt = batch["gt_bboxes"][i][batch["gt_valid"][i]]   # has positives
        for j in range(0, P, 3):
            g = gt[j % len(gt)]
            props[i, j] = g + rng.uniform(-0.15, 0.15, 4) * np.r_[
                g[2:] - g[:2], g[2:] - g[:2]]
    pvalid = np.ones((B, P), bool)
    pvalid[1, -7:] = False
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, f, p, pv, b_: _jax_stages(
        det, v, f, p, pv, b_, jax.random.PRNGKey(11)))(
        var, jfeats, jnp.asarray(props), jnp.asarray(pvalid), jb)
    # the shared mask head's loss, one compile for the three stages
    j_loss_mask = jax.jit(lambda v, f, smp, b_: j_two._mask_branch_loss(
        det, v, f, smp, b_, num_samples=SAMPLES)[0])

    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    for stage, w in enumerate(want):
        head = port.bbox_heads[stage]
        samples = roi.sample_batch_rois(
            t(w["props"]), t(pvalid), pb, t(w["uniforms"]), 20,
            **cascade_rcnn.stage_rcnn_kw(port, stage))
        for k, v in w["samples"].items():
            np.testing.assert_array_equal(samples[k].numpy(), np.asarray(v),
                                          err_msg=f"stage {stage} {k}")
        assert int(samples["is_pos"].sum()) > 8, stage
        got = roi.roi_head_loss(
            head, lambda rf, _s=stage: port(rf, stage="roi", head=_s), pfeats,
            samples, pb, port.strides)
        assert set(got) == set(w["losses"])
        for k, v in w["losses"].items():
            assert abs(float(got[k].detach()) - float(v)) <= 1e-5 * abs(
                float(v)), (stage, k)
        lm = two_stage.mask_branch_losses(port, pfeats, samples, pb,
                                          SAMPLES)["loss_mask"]
        want_lm = float(j_loss_mask(var, jfeats, w["samples"], jb))
        assert abs(float(lm.detach()) - want_lm) <= 1e-5 * want_lm, stage
        with torch.no_grad():
            rf = roi.extract_roi_feats(pfeats, roi.flat_rois(t(w["props"])),
                                       t(pvalid).reshape(-1), port.strides,
                                       head.roi_size)
            refined = cascade_rcnn.decode_stage(
                head, t(w["props"]), port(rf, stage="roi", head=stage)[1])
        assert_boxes_close(refined, w["refined"], rtol=1e-5)


@pytest.mark.parametrize("rcnn", ["list", "single", "ladder"])
def test_stage_rcnn_kw_is_jax(rcnn):
    stages = [dict(assigner=dict(pos_iou_thr=iou, neg_iou_thr=iou,
                                 min_pos_iou=iou),
                   sampler=dict(num=512, pos_fraction=0.25))
              for iou in (0.5, 0.6, 0.7)]
    train_cfg = {"list": dict(rcnn=stages), "single": dict(rcnn=stages[1]),
                 "ladder": None}[rcnn]
    cfg = dict(TINY_CASCADE_RCNN, train_cfg=train_cfg,
               stage_ious=(0.4, 0.55, 0.7))
    det, port = j_build(copy.deepcopy(cfg)), build_detector(copy.deepcopy(cfg))
    for stage in range(3):
        for n in (SAMPLES, None):
            assert (cascade_rcnn.stage_rcnn_kw(port, stage, n)
                    == j_cas._stage_rcnn_kw(det, stage, n)), (stage, n)


def test_sampler_draws_per_stage():
    one = two_stage.sampler_draws(3, 2, 100, 20, "cpu")
    per = two_stage.sampler_draws(3, 2, 100, 20, "cpu", stages=3)
    assert torch.equal(one["rpn"], per["rpn"])
    assert len(per["rcnn"]) == 3 and torch.equal(per["rcnn"][0], one["rcnn"][0])
    assert not torch.equal(per["rcnn"][1], per["rcnn"][2])


def test_cascade_loss_keys_weights_and_no_gradient_through_the_refinement(
        pair, monkeypatch):
    from dsl_tpu_torch.models.detectors import single_stage

    port = copy.deepcopy(pair[2]).train()
    batch = {k: t(v, torch.int64 if k == "gt_labels" else None)
             for k, v in mask_batch(9).items()}
    batch["images"] = U.nchw(U.images(9, B, HW))
    # the weighted losses before they are summed
    losses = {}
    real = single_stage._parse_losses
    monkeypatch.setattr(single_stage, "_parse_losses",
                        lambda d: (losses.update(d), real(d))[1])
    _, log_vars = cascade_rcnn.cascade_rcnn_loss(port, batch, cur_iter=2)
    stage_keys = {f"s{i}.{k}" for i in range(3)
                  for k in ("loss_cls", "loss_bbox", "acc", "loss_mask")}
    assert set(log_vars) == {"loss_rpn_cls", "loss_rpn_bbox", "loss"} | stage_keys
    assert all(bool(torch.isfinite(v)) for v in log_vars.values())
    assert float(log_vars["loss"]) == pytest.approx(float(sum(
        v for k, v in log_vars.items() if "loss" in k and k != "loss")),
        rel=1e-6)
    # stage 2's loss reaches its own head and the features, not the heads
    # of the stages that refined its proposals
    port.zero_grad()
    losses["s2.loss_cls"].backward()
    for i, head in enumerate(port.bbox_heads):
        moved = any(p.grad is not None and bool(p.grad.abs().sum() > 0)
                    for p in head.parameters())
        assert moved == (i == 2), i
    assert port.neck.fpn_convs[0].conv.weight.grad.abs().sum() > 0
    # the stage weights: the same loss with every weight 1
    flat = copy.deepcopy(port)
    flat.stage_loss_weights = (1.0, 1.0, 1.0)
    _, unweighted = cascade_rcnn.cascade_rcnn_loss(flat, batch, cur_iter=2)
    for i, w in enumerate(cascade_rcnn.CASCADE_WEIGHTS):
        for k in ("loss_cls", "loss_bbox", "loss_mask"):
            assert float(log_vars[f"s{i}.{k}"]) == pytest.approx(
                w * float(unweighted[f"s{i}.{k}"]), rel=1e-6)
        assert float(log_vars[f"s{i}.acc"]) == float(unweighted[f"s{i}.acc"])


def test_bridge_round_trip_and_mmdet_pth(pair, tmp_path):
    from dsl_tpu_torch.utils.checkpoint import load_weights
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    np.testing.assert_array_equal(
        back["params"]["bbox_heads_2"]["shared_fc0"]["kernel"],
        var["params"]["bbox_heads_2"]["shared_fc0"]["kernel"])
    again = flax_to_state_dict(back)
    assert sorted(again) == sorted(k for k in sd
                                   if not k.endswith("num_batches_tracked"))
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k
    assert {"roi_head.bbox_head.2.shared_fcs.0.weight",
            "roi_head.bbox_head.0.fc_reg.bias",
            "roi_head.mask_head.convs.1.conv.weight"} <= set(sd)
    assert tuple(sd["roi_head.bbox_head.1.fc_reg.weight"].shape) == (4, 64)
    # an mmdet checkpoint of the same layout loads
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_CASCADE_MASK_RCNN))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    # mmdet's Cascade Mask R-CNN: one mask head per stage
    three = {k: v for k, v in sd.items() if not k.startswith("roi_head.mask_head.")}
    for i in range(3):
        three.update({k.replace("roi_head.mask_head.", f"roi_head.mask_head.{i}."):
                      v for k, v in sd.items()
                      if k.startswith("roi_head.mask_head.")})
    torch.save({"state_dict": three}, path)
    for load in (load_weights, load_torch_detector):
        with pytest.raises(KeyError, match=r"roi_head\.mask_head\.0\."):
            load(str(path), build_detector(copy.deepcopy(TINY_CASCADE_MASK_RCNN)))


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/cascade_rcnn/*.py")))
def test_the_cascade_configs_build(config):
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ == "CascadeRCNN" and len(det.bbox_heads) == 3
    assert all(h.reg_class_agnostic for h in det.bbox_heads)
    assert (det.mask_head is not None) == ("cascade_mask" in config)
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


def test_unported_cascades_raise():
    for change, match in (
            (dict(type="SparseRCNN"), "SparseRCNN"),
            (dict(bbox_heads=[dict(type="SABLHead", num_classes=20)] * 3),
             "SABLHead")):
        with pytest.raises(NotImplementedError, match=match):
            build_detector({**copy.deepcopy(TINY_CASCADE_RCNN), **change})
    with pytest.raises(ValueError, match="3 entries"):
        build_detector(dict(copy.deepcopy(TINY_CASCADE_RCNN),
                            stage_loss_weights=[1.0, 0.5]))


# -- the entry points on a tiny COCO instance set -----------------------------

def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for head in cfg["bbox_heads"] + [cfg["mask_head"]]:
        head["num_classes"] = 80
    return cfg


@pytest.fixture(scope="module")
def pair80():
    return detector_pair(coco80(TINY_CASCADE_MASK_RCNN))


def test_single_device_test_gives_boxes_and_tta(coco, pair80):
    from dsl_tpu_torch.apis.test import single_device_test, tta_test

    ds = _val_dataset(coco)
    port = pair80[2]
    test_cfg = dict(rcnn=dict(TINY_CASCADE_RCNN["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    metrics, results = single_device_test(
        port, None, ds, test_cfg=test_cfg, canvas_hw=HW, img_scale=(96, 64),
        device="cpu", return_results=True)
    assert "bbox_mAP" in metrics and "segm_mAP" not in metrics
    assert all(len(r) == 2 and len(r[0]) > 0 for r in results)
    merged = tta_test(port, None, ds, test_cfg=test_cfg,
                      img_scales=((96, 64),), flip=True, canvas_hw=HW,
                      max_per_img=MAX_DETS, evaluate=False, device="cpu")
    assert len(merged) == len(ds) and all(len(m[0]) > 0 for m in merged)


def test_inference_and_the_test_cli(coco, pair80, tmp_path):
    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    cfg = Config.fromfile(
        "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_CASCADE_MASK_RCNN)
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_cascade.py")
    Config(raw).dump(path)
    ckpt = str(tmp_path / "seeded.pth")
    torch.save(pair80[2].state_dict(), ckpt)
    results, metrics = test_cli.main([path, ckpt, "--eval", "bbox",
                                      "--device", "cpu"])
    assert len(results) == 3 and len(results[0]) == 2
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0
    with pytest.raises(NotImplementedError, match="gives no masks"):
        test_cli.main([path, ckpt, "--eval", "segm", "--device", "cpu"])
    bundle = init_detector(path, ckpt, device="cpu")
    name = _val_dataset(coco).data_infos[0]["filename"]
    per_class = inference_detector(bundle, coco["val_images"] + name)
    assert len(per_class) == 80 and sum(len(c) for c in per_class) > 0


# -- slow: whole-detector comparisons and an epoch ------------------------------

@pytest.mark.slow
def test_cascade_predict_matches_jax(pair):
    det, var, port = pair
    x = U.images(3, B, HW)
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    want = j_cas.cascade_rcnn_predict(det, var, jnp.asarray(x),
                                      img_shapes=jnp.asarray(shapes),
                                      scale_factors=jnp.asarray(sfs))
    got = cascade_rcnn.cascade_rcnn_predict(port, U.nchw(x),
                                            img_shapes=t(shapes),
                                            scale_factors=t(sfs))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)


def jax_cascade_draws(cur_iter: int, b: int, num_anchors: int, num_cand: int,
                      stages: int) -> dict:
    """The uniforms JAX's cascade loss draws at ``cur_iter``: the RPN's as
    the two-stage loss's, each stage's from ``split(rng, stages)``."""
    rng = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.asarray(cur_iter, jnp.uint32))
    rpn = jax.random.uniform(jax.random.fold_in(rng, 97), (b, num_anchors))
    rcnn = tuple(t(jnp.stack([jax.random.uniform(k, (num_cand,))
                              for k in jax.random.split(key, b)]))
                 for key in jax.random.split(rng, stages))
    return dict(rpn=t(rpn), rcnn=rcnn)


@pytest.mark.slow
def test_cascade_loss_matches_jax_banded(pair, monkeypatch):
    """The whole loss with JAX's draws: every loss 1e-5 relative but the
    stages' ``loss_mask``, 1e-3 (a target pixel tied at 0.5 may flip, as
    in the Mask R-CNN file; 8e-5 measured). Each stage samples JAX's RoIs
    here; a refined box that moved by the frameworks' rounding across a
    stage's IoU threshold would change a sample and show."""
    det, var, port = pair
    batch = mask_batch(12)
    batch["images"] = U.images(12, B, HW)
    want = jax.jit(lambda v, b_: j_cas.cascade_rcnn_loss(
        det, v, b_, rng_key=jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.asarray(5, jnp.uint32)))[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(two_stage, "sampler_draws",
                        lambda it, b, a, n, dev, stages=None:
                        jax_cascade_draws(it, b, a, n, stages))
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = cascade_rcnn.cascade_rcnn_loss(copy.deepcopy(port).train(), pb,
                                            cur_iter=5)
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 1e-3 if k.endswith("loss_mask") else 1e-5
        assert abs(float(got[k]) - float(v)) <= rtol * max(abs(float(v)),
                                                           1e-3), k


@pytest.mark.slow
def test_train_cli_on_tiny_coco(coco, tmp_path):
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import train as train_cli

    cfg = Config.fromfile(
        "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_mstrain_3x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_CASCADE_MASK_RCNN)
    raw["canvas_hw"] = list(HW)
    for step in raw["data"]["train"]["pipeline"]:
        if step["type"] == "Resize":
            step["img_scale"] = [(96, 64), (90, 60)]
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    raw["data"]["workers_per_gpu"] = 1
    raw.update(runner=dict(type="EpochBasedRunner", max_epochs=1),
               log_config=dict(interval=1), evaluation=dict(interval=1))
    path = str(tmp_path / "tiny_cascade_train.py")
    Config(raw).dump(path)
    work = tmp_path / "work"
    train_cli.main([path, "--work-dir", str(work), "--device", "cpu"])
    log = [json.loads(x) for x in (work / "train.log.json").read_text()
           .splitlines()]
    steps = [x for x in log if x.get("mode") == "train"]
    assert steps and all(np.isfinite(x[f"s{i}.loss_mask"]) for x in steps
                         for i in range(3))
    val = [x for x in log if x.get("mode") == "val"]
    assert val and 0.0 <= val[-1]["bbox_mAP"] <= 1.0
