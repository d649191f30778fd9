"""The port's HTC, its heads and its data side against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_HTC`` (``TINY_CASCADE_RCNN``'s parts, three 2-conv
32-channel ``HTCMaskHead``s, a 1-conv 32-channel ``FusedSemanticHead`` of
24 classes; 20 classes), f32:

- ``htc.resize_bilinear`` against ``jax.image.resize(..., "bilinear")``
  (the 2x shrink's antialiased taps, odd sizes, enlargements up to 8x and
  the relay head's 7 -> 14): within 1e-5 of the largest magnitude, its
  gradient against ``jax.vjp``'s alike;
- the fused semantic head on random FPN levels (P2 shrunk onto P3), each
  ``HTCMaskHead`` with and without the previous head's features: 1e-5 of
  the largest magnitude;
- ``semantic_seg_loss`` with 255 and labels past the classes: 1e-6
  relative;
- ``paste_gt_crops`` within 1e-6, and the semantic target equal but where
  JAX's pasted value lies within 1e-6 of 0.5 (counted, as the mask
  targets' ties in the Mask R-CNN file);
- slow (12 s, one compile of JAX's three stages): per stage, on random
  levels, a random semantic embedding and JAX's
  proposals of that stage: the sampler fed JAX's uniforms gives JAX's
  samples (equal), ``loss_cls`` and ``loss_bbox`` with the semantic RoI
  features 1e-5 relative, ``loss_mask`` through the information flow
  (JAX's targets handed to both) 1e-5 relative, the refinement (no
  semantic features) as the cascade file's boxes;
- the loss's keys, the information flow's gradients (stage 2's mask loss
  reaches heads 0-2, stage 0's head 0 alone) and the semantic loss's;
- the weight bridge both ways and an mmdet-keyed ``.pth`` loaded;
- every config of ``configs/htc/`` built on the meta device (the dconv
  one with its deformable convs), with the JAX package's parameter counts
  for two;
- ``LoadAnnotations(with_seg=True)`` (a gray PNG under ``seg_prefix``,
  and none), ``Resize``, ``RandomFlip``, ``Pad`` and ``SegRescale(1/8)``:
  ``gt_semantic_seg`` bit for bit JAX's; a colour PNG refused; through a
  dataset (``seg_prefix`` dropped) all 255, and no batch key;
- ``single_device_test`` on the tiny HTC gives boxes, ``inference_detector``
  and the test CLI (``--eval bbox``; ``--eval segm`` refused);
- slow: JAX's ``single_device_test`` raising on HTC's four outputs, the
  whole predict (labels and valid equal, dets within 1e-4 plus 1e-5 of
  their magnitude, probabilities 1e-5) and the whole loss with JAX's
  draws (1e-5 relative, the stages' ``loss_mask`` 1e-3 for target ties)
  against JAX's, and one epoch of the train CLI through the COCO
  instance-semantic pipeline.
"""

import copy
import glob
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.data.pipelines import Compose as JCompose
from dsl_tpu.models.dense_heads import yolact_head as j_yolact
from dsl_tpu.models.detectors import cascade_rcnn as j_cas
from dsl_tpu.models.roi_heads import htc as j_htc
from dsl_tpu.models.roi_heads import mask_head as j_mask
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu_torch.data.formatting import format_sample
from dsl_tpu_torch.data.pipelines import Compose
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.dense_heads.yolact_head import paste_gt_crops
from dsl_tpu_torch.models.detectors import cascade_rcnn, two_stage
from dsl_tpu_torch.models.roi_heads import htc
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.models.roi_heads.mask_head import mask_head_loss
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.synthetic_data import TINY_HTC, coco_instance_config
from test_torch_port_cascade import (
    B, HW, P, SAMPLES, _levels, assert_boxes_close, detector_pair, rel_err,
    random_boxes, t)
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _val_dataset, coco, mask_batch)
from test_torch_port_masks import NORM, _datasets, _results

torch.set_num_threads(2)

TIE = 1e-6          # a target pixel may differ where JAX's paste is this near 0.5
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"htc/htc_r50_fpn_1x_coco.py": 80258293,
           "htc/htc_without_semantic_r50_fpn_1x_coco.py": 77456190}
SEG_PIPELINE = [          # configs/_base_/datasets/coco_instance_semantic.py's
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True, with_mask=True, with_seg=True),
    dict(type="Resize", img_scale=[(160, 96), (200, 120), (96, 64)],
         multiscale_mode="value", keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
    dict(type="SegRescale", scale_factor=1 / 8),
]


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_HTC)


def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for head in cfg["bbox_heads"] + cfg["mask_heads"]:
        head["num_classes"] = 80
    cfg["semantic_head"]["num_classes"] = 84
    return cfg


@pytest.fixture(scope="module")
def pair80():
    return detector_pair(coco80(TINY_HTC))


# -- the resize and the heads ----------------------------------------------------

@pytest.mark.parametrize("src,dst", [((16, 24), (8, 12)), ((15, 23), (8, 12)),
                                     ((4, 6), (8, 12)), ((2, 3), (8, 12)),
                                     ((1, 2), (8, 12)), ((7, 7), (14, 14))])
def test_resize_is_jax_image_resize(src, dst):
    x = np.random.RandomState(sum(src)).randn(2, 5, *src).astype(np.float32)
    want = jax.jit(lambda a: jax.image.resize(a, (2, *dst, 5), "bilinear"))(
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = htc.resize_bilinear(torch.from_numpy(x), dst)
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5
    # the weights are JAX's: each output row sums to one
    for s, d in zip(src, dst):
        np.testing.assert_allclose(htc.jax_resize_weights(s, d).sum(1), 1.0,
                                   rtol=1e-6)


def test_resize_gradient_is_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 3, 16, 24).astype(np.float32)
    g = rng.randn(1, 3, 8, 12).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (1, 8, 12, 3), "bilinear"),
                     jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))[0]
    xt = torch.from_numpy(x).requires_grad_()
    htc.resize_bilinear(xt, (8, 12)).backward(torch.from_numpy(g))
    assert rel_err(xt.grad.permute(0, 2, 3, 1), want) < 1e-5


def test_fused_semantic_head_matches_jax(pair):
    det, var, port = pair
    jfeats, pfeats = _levels(pair, 21)
    assert tuple(pfeats[0].shape[2:]) == (16, 24)     # P2, shrunk onto P3
    want = jax.jit(lambda v, f: det.apply(v, f, method=det.semantic_forward))(
        var, jfeats)
    got = port(pfeats, stage="semantic")
    assert tuple(got[0].shape) == (B, 24, 8, 12)
    for g, w in zip(got, want):
        assert rel_err(g.permute(0, 2, 3, 1), w) < 1e-5


@pytest.mark.parametrize("stage,res", [(0, False), (1, False), (1, True),
                                       (2, True)])
def test_htc_mask_heads_match_jax(pair, stage, res):
    det, var, port = pair
    rng = np.random.RandomState(stage + 3 * res)
    x = rng.randn(5, 14, 14, 32).astype(np.float32)
    r = rng.randn(5, 14, 14, 32).astype(np.float32) if res else None
    want = det.apply(var, jnp.asarray(x), stage,
                     None if r is None else jnp.asarray(r),
                     method=det.htc_mask_forward)
    got = port(U.nchw(x), stage="htc_mask", head=stage,
               res_feat=None if r is None else U.nchw(r))
    assert tuple(got[0].shape) == (5, 20, 28, 28)
    for g, w in zip(got, want):
        assert rel_err(g.permute(0, 2, 3, 1), w) < 1e-5


def test_semantic_seg_loss_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 8, 12, 24).astype(np.float32)
    target = rng.randint(0, 24, (2, 8, 12))
    target[0, :3] = 255
    target[1, :, :2] = 30                   # past the classes: ignored
    want = jax.jit(j_htc.semantic_seg_loss)(jnp.asarray(logits),
                                            jnp.asarray(target))
    got = htc.semantic_seg_loss(U.nchw(logits), torch.from_numpy(target))
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    none = htc.semantic_seg_loss(U.nchw(logits),
                                 torch.full((2, 8, 12), 255))
    assert float(none) == 0.0


@pytest.mark.parametrize("seg_hw", [(8, 12), (16, 24)])
def test_paste_and_semantic_target_match_jax(pair, seg_hw):
    det = pair[0]
    batch = mask_batch(13)
    batch["images"] = U.images(13, B, HW)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_fn(b_):
        return (jax.vmap(j_yolact.paste_gt_crops,
                         in_axes=(0, 0, 0, None, None))(
                    b_["gt_mask_crops"], b_["gt_bboxes"], b_["gt_valid"],
                    seg_hw, HW),
                j_cas._htc_semantic_target(det, b_, seg_hw))

    want, want_t = (np.asarray(a) for a in jax_fn(jb))
    got = paste_gt_crops(t(batch["gt_mask_crops"]), t(batch["gt_bboxes"]),
                         t(batch["gt_valid"]), seg_hw, HW)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    got_t = cascade_rcnn.htc_semantic_target(24, pb, seg_hw).numpy()
    assert (want_t > 0).sum() > 10
    differ = got_t != want_t
    ties = (np.abs(want - 0.5) <= TIE).any(1)
    assert not (differ & ~ties).any()
    print(f"semantic target {seg_hw}: {int(differ.sum())} pixels differ, "
          f"each a tie at 0.5")


# -- the stages -----------------------------------------------------------------

def _jax_htc_stages(det, var, feats, sem, props, pvalid, batch, rng):
    """JAX's HTC loss, stage by stage as ``htc_loss`` runs it on the given
    levels and semantic embedding: each stage's proposals, uniforms,
    samples, losses and (for the next stage) refined proposals."""
    keys = jax.random.split(rng, len(det.bbox_heads))
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
        rf = (j_roi.extract_roi_feats(feats, flat, valid, strides,
                                      head.roi_size)
              + j_cas._semantic_roi_feats(sem, flat, valid, head.roi_size))
        losses = j_roi.rcnn_bbox_loss(
            head, *det.apply(var, rf, stage, method=det.roi_forward), samples,
            batch)
        prois, plabels, passigned, ppos = j_mask.select_positive_rois(
            samples["rois"], samples["labels"], samples["assigned"],
            samples["is_pos"], SAMPLES // 4)
        pidx = jnp.repeat(jnp.arange(B), SAMPLES // 4)
        pflat = jnp.concatenate([pidx[:, None].astype(jnp.float32),
                                 prois.reshape(-1, 4)], 1)
        pv = ppos.reshape(-1)
        mf = (j_roi.extract_roi_feats(feats, pflat, pv, strides, 14)
              + j_cas._semantic_roi_feats(sem, pflat, pv, 14))
        res = None
        for j in range(stage + 1):
            logits, res = det.apply(var, mf, j, res,
                                    method=det.htc_mask_forward)
        targets = j_mask.mask_targets_from_crops(
            batch["gt_mask_crops"], batch["gt_bboxes"], prois.reshape(-1, 4),
            pidx, passigned.reshape(-1), mask_size=28)
        losses["loss_mask"] = j_mask.mask_head_loss(
            logits, targets, plabels.reshape(-1), pv.astype(jnp.float32), 20)
        aflat = jnp.concatenate([jnp.repeat(jnp.arange(B, dtype=jnp.float32),
                                            props.shape[1])[:, None],
                                 props.reshape(-1, 4)], 1)
        rf = j_roi.extract_roi_feats(feats, aflat, pvalid.reshape(-1),
                                     strides, head.roi_size)
        refined = j_cas._decode_stage(
            head, props, det.apply(var, rf, stage, method=det.roi_forward)[1])
        out.append(dict(props=props, uniforms=uniforms, samples=samples,
                        losses=losses, refined=refined))
        props = refined
    return out


def near_gt_proposals(batch: dict, seed: int) -> np.ndarray:
    """Random boxes, a third of them jittered GT boxes, so that every stage
    has positives."""
    rng = np.random.RandomState(seed)
    props = random_boxes(rng, (B, P))
    for i in range(B):
        gt = batch["gt_bboxes"][i][batch["gt_valid"][i]]
        for j in range(0, P, 3):
            g = gt[j % len(gt)]
            props[i, j] = g + rng.uniform(-0.15, 0.15, 4) * np.r_[
                g[2:] - g[:2], g[2:] - g[:2]]
    return props


@pytest.mark.slow
def test_htc_stage_losses_match_jax_given_its_samples(pair, monkeypatch):
    det, var, port = pair
    jfeats, pfeats = _levels(pair, 22)
    sem = np.random.RandomState(23).randn(B, 8, 12, 32).astype(np.float32)
    batch = mask_batch(24)
    props = near_gt_proposals(batch, 25)
    pvalid = np.ones((B, P), bool)
    pvalid[1, -7:] = False
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, f, s, p, pv, b_: _jax_htc_stages(
        det, v, f, s, p, pv, b_, jax.random.PRNGKey(26)))(
        var, jfeats, jnp.asarray(sem), jnp.asarray(props),
        jnp.asarray(pvalid), jb)
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    psem = U.nchw(sem)
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
        rf = (roi.extract_roi_feats(pfeats, rois, valid, port.strides, 7)
              + cascade_rcnn.semantic_roi_feats(psem, rois, valid, 7))
        got = roi.rcnn_bbox_loss(head, *port(rf, stage="roi", head=stage),
                                 samples, pb)
        prois, plabels, passigned, ppos = cascade_rcnn._mask_rois(
            samples, SAMPLES // 4)
        mf = (roi.extract_roi_feats(pfeats, prois, ppos, port.strides, 14)
              + cascade_rcnn.semantic_roi_feats(psem, prois, ppos, 14))
        res = None
        for j in range(stage + 1):
            logits, res = port(mf, stage="htc_mask", head=j, res_feat=res)
        got["loss_mask"] = mask_head_loss(
            logits, cascade_rcnn._mask_targets(pb, prois, passigned, 28),
            plabels, ppos.to(torch.float32), 20)
        for k, v in w["losses"].items():
            assert abs(float(got[k].detach()) - float(v)) <= 1e-5 * max(
                abs(float(v)), 1e-6), (stage, k)
        with torch.no_grad():
            rf = roi.extract_roi_feats(pfeats, roi.flat_rois(t(w["props"])),
                                       t(pvalid).reshape(-1), port.strides, 7)
            refined = cascade_rcnn.decode_stage(
                head, t(w["props"]), port(rf, stage="roi", head=stage)[1])
        assert_boxes_close(refined, w["refined"], rtol=1e-5)


def test_htc_loss_keys_and_the_information_flow(pair, monkeypatch):
    from dsl_tpu_torch.models.detectors import single_stage

    port = copy.deepcopy(pair[2]).train()
    batch = {k: t(v, torch.int64 if k == "gt_labels" else None)
             for k, v in mask_batch(27).items()}
    batch["images"] = U.nchw(U.images(27, B, HW))
    losses = {}
    real = single_stage._parse_losses
    monkeypatch.setattr(single_stage, "_parse_losses",
                        lambda d: (losses.update(d), real(d))[1])
    _, log_vars = single_stage.detector_loss(port, batch, cur_iter=3)
    stage_keys = {f"s{i}.{k}" for i in range(3)
                  for k in ("loss_cls", "loss_bbox", "loss_mask")}
    assert set(log_vars) == ({"loss_rpn_cls", "loss_rpn_bbox",
                              "loss_semantic_seg", "loss"} | stage_keys)
    assert all(bool(torch.isfinite(v)) for v in log_vars.values())

    def moved(module):
        return any(p.grad is not None and bool(p.grad.abs().sum() > 0)
                   for p in module.parameters())

    for stage, reach in ((2, (0, 1, 2)), (0, (0,))):
        port.zero_grad()
        losses[f"s{stage}.loss_mask"].backward(retain_graph=True)
        assert [moved(h) for h in port.mask_heads] == [
            i in reach for i in range(3)], stage
        assert moved(port.semantic_head) and not moved(port.bbox_heads[0])
    port.zero_grad()
    losses["loss_semantic_seg"].backward(retain_graph=True)
    assert moved(port.semantic_head) and not moved(port.mask_heads[0])
    # HTC without the semantic head trains without its loss
    cfg = dict(copy.deepcopy(TINY_HTC), semantic_head=None)
    bare = build_detector(cfg).train()
    _, lv = single_stage.detector_loss(bare, batch, cur_iter=3)
    assert "loss_semantic_seg" not in lv and "s2.loss_mask" in lv


def test_bridge_round_trip_and_mmdet_pth(pair, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    for head in ("mask_heads_1", "semantic_head"):
        for name, leaves in var["params"][head].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(back["params"][head][name][leaf],
                                              v)
    again = flax_to_state_dict(back)
    assert all(torch.equal(v, sd[k]) for k, v in again.items())
    assert {"roi_head.mask_head.0.convs.1.conv.weight",
            "roi_head.mask_head.2.conv_res.conv.weight",
            "roi_head.mask_head.1.upsample.weight",
            "roi_head.semantic_head.lateral_convs.4.conv.weight",
            "roi_head.semantic_head.convs.0.conv.weight",
            "roi_head.semantic_head.conv_embedding.conv.bias",
            "roi_head.semantic_head.conv_logits.weight"} <= set(sd)
    assert "roi_head.mask_head.0.conv_res.conv.weight" not in sd
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_HTC))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/htc/*.py")))
def test_the_htc_configs_build(config):
    from dsl_tpu_torch.config import Config

    from dsl_tpu_torch.ops.deform_conv import DeformConv2dPack

    model = dict(Config.fromfile(f"configs/{config}").model)
    with torch.device("meta"):
        det = build_detector(model)
    assert any(isinstance(m, DeformConv2dPack) for m in det.modules()) == (
        "dconv" in config)
    assert type(det).__name__ == "HTC" and len(det.mask_heads) == 3
    assert (det.semantic_head is None) == ("without_semantic" in config)
    assert det.mask_heads[0].conv_res is None and det.mask_heads[2].conv_res
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


# -- the data side -----------------------------------------------------------------

def _seg_maps(coco, tmp_path, color: bool = False) -> str:
    """A gray PNG semantic map per train image, named after it."""
    jds, _ = _datasets(coco)
    rng = np.random.RandomState(3)
    for info in jds.data_infos:
        h, w = info["height"], info["width"]
        seg = rng.randint(0, 183, (h, w)).astype(np.uint8)
        seg[: h // 4] = 255
        if color:
            seg = np.stack([seg, seg // 2, seg // 3], -1)
        name = info["filename"].rsplit(".", 1)[0] + ".png"
        cv2.imwrite(str(tmp_path / name), seg)
    return str(tmp_path) + "/"


@pytest.mark.parametrize("seed,prefix", [(0, True), (1, True), (2, True),
                                         (3, False)])
def test_semantic_map_pipeline_is_jax(coco, tmp_path, seed, prefix):
    jds, pds = _datasets(coco)
    i = seed % len(jds)
    seg_prefix = _seg_maps(coco, tmp_path) if prefix else None
    np.random.seed(seed)
    jr = _results(jds, i)
    pr = _results(pds, i, "cpu")
    jr["seg_prefix"] = pr["seg_prefix"] = seg_prefix
    ref = JCompose(copy.deepcopy(SEG_PIPELINE))(jr)
    gen = np.random.RandomState(seed)
    got = Compose(copy.deepcopy(SEG_PIPELINE))(pr, gen)
    np.testing.assert_array_equal(got["gt_semantic_seg"].numpy(),
                                  ref["gt_semantic_seg"])
    assert got["flip"] == ref["flip"] and got["scale"] == ref["scale"]
    assert (ref["gt_semantic_seg"] != 255).any() == prefix
    assert "gt_semantic_seg" not in format_sample(got, canvas_hw=(128, 224),
                                                  max_gt=8)


def test_a_colour_semantic_map_is_refused(coco, tmp_path):
    _, pds = _datasets(coco)
    r = _results(pds, 0, "cpu")
    r["seg_prefix"] = _seg_maps(coco, tmp_path, color=True)
    with pytest.raises(NotImplementedError, match="no route to gray"):
        Compose([dict(type="LoadAnnotations", with_seg=True)])(
            r, np.random.RandomState(0))


def test_a_dataset_drops_seg_prefix(coco, tmp_path):
    import random

    from dsl_tpu_torch.registry import DATASETS, build_from_cfg

    ds = build_from_cfg(dict(
        type="CocoDataset", ann_file=coco["train"],
        img_prefix=coco["train_images"], seg_prefix=_seg_maps(coco, tmp_path),
        pipeline=copy.deepcopy(SEG_PIPELINE), device="cpu",
        rng=np.random.RandomState(0), pyrng=random.Random(0)), DATASETS)
    out = ds[0]
    assert bool((out["gt_semantic_seg"] == 255).all())


# -- the entry points on a tiny COCO instance set ---------------------------------

def test_single_device_test_gives_boxes(coco, pair80):
    from dsl_tpu_torch.apis.test import single_device_test

    test_cfg = dict(rcnn=dict(TINY_HTC["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    metrics, results = single_device_test(
        pair80[2], None, _val_dataset(coco), test_cfg=test_cfg, canvas_hw=HW,
        img_scale=(96, 64), device="cpu", return_results=True)
    assert "bbox_mAP" in metrics and "segm_mAP" not in metrics
    assert all(len(r) == 2 and len(r[0]) > 0 for r in results)


def test_inference_and_the_test_cli(coco, pair80, tmp_path):
    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    cfg = Config.fromfile("configs/htc/htc_r50_fpn_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_HTC)
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_htc.py")
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
def test_jax_single_device_test_raises_on_htc(coco, pair80):
    """The JAX function unpacks three outputs for a detector outside its
    mask list, and HTC's predict gives four."""
    from dsl_tpu.apis.test import single_device_test as j_test

    det, var, _ = pair80
    with pytest.raises(ValueError, match="too many values to unpack"):
        j_test(det, var, _val_dataset(coco, port=False),
               test_cfg=dict(rcnn=dict(TINY_HTC["test_cfg"]["rcnn"],
                                       max_per_img=MAX_DETS)),
               canvas_hw=HW, img_scale=(96, 64))


def predict_against_jax(pair, jax_predict, port_predict):
    det, var, port = pair
    x = U.images(3, B, HW)
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    want = jax_predict(det, var, jnp.asarray(x), img_shapes=jnp.asarray(shapes),
                       scale_factors=jnp.asarray(sfs))
    got = port_predict(port, U.nchw(x), img_shapes=t(shapes),
                       scale_factors=t(sfs))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    assert int(got[2].sum()) > 20
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               atol=1e-5)


@pytest.mark.slow
def test_htc_predict_matches_jax(pair):
    predict_against_jax(pair, j_cas.htc_predict, cascade_rcnn.htc_predict)


def jax_split_draws(split: int):
    """``two_stage.sampler_draws``' stand-in: JAX's uniforms at
    ``cur_iter``, the RPN's as the two-stage loss's, stage ``i``'s from
    ``split(rng, split)[i]``."""
    def draws(cur_iter, b, num_anchors, num_cand, device, stages=1):
        rng = jax.random.fold_in(jax.random.PRNGKey(0),
                                 jnp.asarray(cur_iter, jnp.uint32))
        rpn = jax.random.uniform(jax.random.fold_in(rng, 97), (b, num_anchors))
        rcnn = tuple(t(jnp.stack([jax.random.uniform(k, (num_cand,))
                                  for k in jax.random.split(key, b)]))
                     for key in jax.random.split(rng, split)[:stages])
        return dict(rpn=t(rpn), rcnn=rcnn)
    return draws


def loss_against_jax(pair, jax_loss, port_loss, split: int, monkeypatch):
    """The whole loss with JAX's draws: every loss 1e-5 relative but
    ``loss_mask``, 1e-3 (a target pixel tied at 0.5 may flip)."""
    det, var, port = pair
    batch = mask_batch(12)
    batch["images"] = U.images(12, B, HW)
    want = jax.jit(lambda v, b_: jax_loss(
        det, v, b_, rng_key=jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.asarray(5, jnp.uint32)))[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(two_stage, "sampler_draws", jax_split_draws(split))
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = port_loss(copy.deepcopy(port).train(), pb, cur_iter=5)
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 1e-3 if k.endswith("loss_mask") or k == "loss" else 1e-5
        assert abs(float(got[k]) - float(v)) <= rtol * max(abs(float(v)),
                                                           1e-3), k


@pytest.mark.slow
def test_htc_loss_matches_jax_banded(pair, monkeypatch):
    loss_against_jax(pair, j_cas.htc_loss, cascade_rcnn.htc_loss, 3,
                     monkeypatch)


@pytest.mark.slow
def test_train_cli_through_the_semantic_pipeline(coco, tmp_path):
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import train as train_cli

    cfg = Config.fromfile("configs/htc/htc_r50_fpn_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_HTC)
    raw["canvas_hw"] = list(HW)
    pipe = copy.deepcopy(Config.fromfile(
        "configs/_base_/datasets/coco_instance_semantic.py").train_pipeline)
    for step in pipe:
        if step["type"] == "Resize":
            step["img_scale"] = (96, 64)
    raw["data"]["train"]["pipeline"] = pipe
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    raw["data"]["workers_per_gpu"] = 1
    raw.update(runner=dict(type="EpochBasedRunner", max_epochs=1),
               log_config=dict(interval=1), evaluation=dict(interval=1))
    path = str(tmp_path / "tiny_htc_train.py")
    Config(raw).dump(path)
    work = tmp_path / "work"
    train_cli.main([path, "--work-dir", str(work), "--device", "cpu"])
    log = [json.loads(x) for x in (work / "train.log.json").read_text()
           .splitlines()]
    steps = [x for x in log if x.get("mode") == "train"]
    assert steps and all(np.isfinite(x[k]) for x in steps for k in
                         ["loss_semantic_seg"]
                         + [f"s{i}.loss_mask" for i in range(3)])
    val = [x for x in log if x.get("mode") == "val"]
    assert val and 0.0 <= val[-1]["bbox_mAP"] <= 1.0
