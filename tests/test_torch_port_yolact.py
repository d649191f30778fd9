"""The port's YOLACT against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_YOLACT`` (ResNet-18 with nothing frozen, the
bilinear FPN 32 wide, a 32-wide head of 8 prototypes; 20 classes), f32:

- the bilinear FPN's levels (``jax.image.resize`` to the lateral's size,
  odd sizes included), the head's three outputs per level, the protonet's
  prototypes and the segm head's logits: 1e-5 of the largest magnitude;
- ``fast_nms`` on a batch with tied scores and fewer candidates than
  slots: dets, labels, ``box_idx`` (the invalid slots' too, which choose
  the coefficients of the empty crops) and valid equal;
- ``yolact_loss`` per key (``max_masks_to_train`` 100, and 5, where the
  choice of the first positives among the 0/1 flags matters): 1e-5
  relative;
- ``yolact_predict`` with tied class scores at a small ``nms_pre``: valid
  and the labels on the valid rows equal, the dets there within an ulp of
  their magnitude (the decode's exp rounds an ulp apart in the two), the
  56x56 crops 1e-5;
- ``_crop_mask`` in the padded canvas's frame against JAX's;
- the weight bridge both ways and an mmdet-keyed ``.pth`` (the protonet's
  ``Sequential`` indices 0, 2, 4, 8, 10);
- every config of ``configs/yolact/`` built on the meta device, with the
  JAX package's parameter count for one; the box-only pipeline's batch
  refused with ``KeyError`` naming ``gt_mask_crops`` in both packages;
- ``single_device_test`` with ``segm`` and the test CLI's ``--eval bbox
  segm`` on a tiny COCO instance set;
- slow: the whole predict and loss against JAX's on the detector's own
  outputs, and one epoch of ``train_detector`` through the COCO instance
  pipeline.
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
from dsl_tpu.core.nms import fast_nms as j_fast_nms
from dsl_tpu.models.dense_heads import yolact_head as j_yolact
from dsl_tpu_torch.core import nms as tnms
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors.single_stage import detector_loss
from dsl_tpu_torch.models.dense_heads import yolact_head as yolact
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.synthetic_data import TINY_YOLACT, coco_instance_config
from test_torch_port_cascade import detector_pair, rel_err
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _val_dataset, coco, mask_batch)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
NC = 20
# the JAX package's parameter count (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"yolact/yolact_r50_1x8_coco.py": 35293711}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_YOLACT)


def _to_jax_layout(outputs):
    """The port's five outputs in the JAX package's layout (the prototypes
    and segm logits NHWC)."""
    cls, reg, coeff, protos, segm = outputs
    return (cls, reg, coeff, protos.permute(0, 2, 3, 1),
            segm.permute(0, 2, 3, 1))


# -- the modules ------------------------------------------------------------------

@pytest.mark.parametrize("hw", [HW, (72, 100)])
def test_bilinear_fpn_matches_jax(pair, hw):
    det, var, port = pair
    x = U.images(1, 1, hw)
    want = det.apply(var, jnp.asarray(x), method=det.extract_feat)
    with torch.no_grad():
        got = port.extract_feat(U.nchw(x))
    assert [tuple(g.shape[2:]) for g in got] == [w.shape[1:3] for w in want]
    for g, w in zip(got, want):
        assert rel_err(g.permute(0, 2, 3, 1), w) < 1e-5


def test_head_protonet_and_segm_match_jax(pair):
    det, var, port = pair
    x = U.images(2, B, HW)
    want = det.apply(var, jnp.asarray(x))
    with torch.no_grad():
        got = _to_jax_layout(port(U.nchw(x)))
    assert tuple(got[3].shape) == (B, 16, 24, 8)
    assert tuple(got[4].shape) == (B, 8, 12, NC)
    for g, w in zip(got[:3], want[:3]):
        for gl, wl in zip(g, w):
            assert rel_err(gl, wl) < 1e-5
    for g, w in zip(got[3:], want[3:]):
        assert rel_err(g, w) < 1e-5


def _nms_inputs(seed: int):
    rng = np.random.RandomState(seed)
    n = 300
    x1, y1 = rng.uniform(0, 80, (B, n)), rng.uniform(0, 50, (B, n))
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 30, (B, n)),
                      y1 + rng.uniform(4, 30, (B, n))], -1).astype(np.float32)
    scores = rng.choice([0.01, 0.07, 0.2, 0.5, 0.9], (B, n, NC),
                        p=[0.9, 0.04, 0.03, 0.02, 0.01]).astype(np.float32)
    scores[1, :, 2:] = 0.0              # image 1: few candidates, many slots
    scores[1, 60:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("top_k,max_num", [(200, 100), (20, 300)])
def test_fast_nms_matches_jax(top_k, max_num):
    boxes, scores = _nms_inputs(3)
    got = tnms.fast_nms(t(boxes), t(scores), score_thr=0.05,
                        iou_threshold=0.5, top_k=top_k, max_num=max_num)
    for i in range(B):
        want = j_fast_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                          score_thr=0.05, iou_threshold=0.5, top_k=top_k,
                          max_num=max_num)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert not bool(got[3][1].all()) and bool(got[3][0].any())


def test_crop_mask_matches_jax():
    rng = np.random.RandomState(4)
    masks = rng.rand(5, 16, 24).astype(np.float32)
    boxes = np.stack([rng.uniform(-5, 60, 5), rng.uniform(-5, 40, 5),
                      rng.uniform(60, 100, 5), rng.uniform(40, 70, 5)],
                     1).astype(np.float32)
    for hw in ((64, 96), (70, 90)):
        want = jax.vmap(j_yolact._crop_mask, in_axes=(0, 0, None))(
            jnp.asarray(masks), jnp.asarray(boxes), hw)
        got = yolact._crop_mask(t(masks), t(boxes), hw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_outputs(seed: int, tied: bool = False):
    """Head outputs of the tiny YOLACT's shapes at 64x96, NHWC (the JAX
    layout); with ``tied`` the class logits repeat across anchors, so
    their best scores tie."""
    rng = np.random.RandomState(seed)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    cls = [rng.randn(B, h, w, 3 * (NC + 1)).astype(np.float32) * 2
           for h, w in sizes]
    if tied:
        rows = rng.randn(4, NC + 1).astype(np.float32) * 2
        rows[:, :NC] += 3
        cls = [rows[rng.randint(0, 4, (B, h, w, 3))].reshape(B, h, w, -1)
               for h, w in sizes]
    reg = [rng.randn(B, h, w, 12).astype(np.float32) * 0.5 for h, w in sizes]
    coeff = [np.tanh(rng.randn(B, h, w, 24)).astype(np.float32)
             for h, w in sizes]
    protos = np.maximum(rng.randn(B, 16, 24, 8), 0).astype(np.float32)
    segm = rng.randn(B, 8, 12, NC).astype(np.float32)
    return cls, reg, coeff, protos, segm


def _port_outputs(out):
    cls, reg, coeff, protos, segm = out
    return ([t(c) for c in cls], [t(r) for r in reg], [t(c) for c in coeff],
            U.nchw(protos), U.nchw(segm))


def _jax_outputs(out):
    cls, reg, coeff, protos, segm = out
    return (tuple(jnp.asarray(c) for c in cls),
            tuple(jnp.asarray(r) for r in reg),
            tuple(jnp.asarray(c) for c in coeff), jnp.asarray(protos),
            jnp.asarray(segm))


def _loss_batch(seed: int) -> dict:
    batch = mask_batch(seed)
    batch["images"] = U.images(seed, B, HW)
    return batch


@pytest.mark.parametrize("max_masks", [100, 5])
def test_yolact_loss_matches_jax(max_masks):
    cfg = dict(TINY_YOLACT["bbox_head"], max_masks_to_train=max_masks)
    jhead = j_yolact.YOLACTHead(**{k: v for k, v in cfg.items()
                                   if k != "type"})
    head = yolact.YOLACTHead(**{k: v for k, v in cfg.items() if k != "type"})
    out = _random_outputs(5)
    batch = _loss_batch(6)
    want = jax.jit(lambda o, b_: j_yolact.yolact_loss(jhead, o, b_))(
        _jax_outputs(out), {k: jnp.asarray(v) for k, v in batch.items()})
    pb = {k: t(v) for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    got = yolact.yolact_loss(head, _port_outputs(out), pb)
    assert set(got) == set(want) == {"loss_cls", "loss_bbox", "loss_mask",
                                     "loss_segm"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k


def test_yolact_predict_matches_jax_with_tied_scores():
    head = yolact.YOLACTHead(**{k: v for k, v in TINY_YOLACT["bbox_head"].items()
                                if k != "type"})
    jhead = j_yolact.YOLACTHead(**{k: v for k, v in
                                   TINY_YOLACT["bbox_head"].items()
                                   if k != "type"})
    out = _random_outputs(7, tied=True)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    kw = dict(nms_pre=40, score_thr=0.05, iou_threshold=0.5, max_per_img=50)
    want = jax.jit(lambda o, s: j_yolact.yolact_predict(
        jhead, o, scale_factors=s, img_hw=HW, **kw))(_jax_outputs(out),
                                                    jnp.asarray(sfs))
    got = yolact.yolact_predict(head, _port_outputs(out),
                                scale_factors=t(sfs), img_hw=HW, **kw)
    valid = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(want[1])[valid])
    # torch's exp and JAX's round the decode an ulp apart
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid],
                               rtol=1e-6, atol=1e-5)
    assert tuple(got[3].shape) == (B, 50, 56, 56)
    assert float((got[3] - t(want[3])).abs().max()) < 1e-5


# -- weights, configs, refusals ------------------------------------------------------

def test_bridge_and_mmdet_pth_round_trip(pair, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    for k in ("proto_conv2", "post_up_conv", "proto_out"):
        np.testing.assert_array_equal(back["params"]["proto_head"][k]["kernel"],
                                      var["params"]["proto_head"][k]["kernel"])
    again = flax_to_state_dict(back)
    assert sorted(again) == sorted(k for k in sd
                                   if not k.endswith("num_batches_tracked"))
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k
    assert {f"mask_head.protonet.{i}.weight" for i in (0, 2, 4, 8, 10)} | {
        "bbox_head.head_convs.0.conv.weight", "bbox_head.conv_coeff.bias",
        "segm_head.segm_conv.weight"} <= set(sd)
    assert tuple(sd["mask_head.protonet.10.weight"].shape) == (8, 32, 1, 1)
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_YOLACT))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/yolact/*.py")))
def test_the_yolact_configs_build(config):
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ == "YOLACT"
    assert det.neck.upsample_mode == "bilinear"
    # nothing frozen (frozen_stages=-1): the stem trains, as in JAX
    assert all(p.requires_grad for p in det.parameters())
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


def test_a_box_only_batch_is_refused_as_in_jax(pair):
    det, var, port = pair
    batch = _loss_batch(8)
    del batch["gt_mask_crops"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(KeyError, match="gt_mask_crops"):     # while tracing
        jax.jit(lambda v, b_: j_yolact.yolact_loss(
            det.bbox_head, det.apply(v, b_["images"]), b_))(var, jb)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    with pytest.raises(KeyError, match="gt_mask_crops"):
        detector_loss(port, pb)


def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for key in ("bbox_head", "segm_head"):
        cfg[key]["num_classes"] = 80
    return cfg


def test_single_device_test_and_cli_with_segm(coco, tmp_path):
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    port = detector_pair(coco80(TINY_YOLACT))[2]
    test_cfg = dict(TINY_YOLACT["test_cfg"], max_per_img=MAX_DETS)
    metrics, results = single_device_test(
        port, None, _val_dataset(coco), test_cfg=test_cfg, canvas_hw=HW,
        img_scale=(96, 64), device="cpu", return_results=True)
    assert all(0.0 <= metrics[k] <= 1.0 for k in ("bbox_mAP", "segm_mAP"))
    assert all(len(r) == 3 and len(r[2]) == len(r[0]) > 0 for r in results)
    raw = coco_instance_config(Config.fromfile(
        "configs/yolact/yolact_r50_1x8_coco.py").to_dict(), coco)
    raw["model"] = dict(coco80(TINY_YOLACT), test_cfg=test_cfg)
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_yolact.py")
    Config(raw).dump(path)
    ckpt = str(tmp_path / "seeded.pth")
    torch.save(port.state_dict(), ckpt)
    out = str(tmp_path / "dets.bbox.json")
    cli_results, cli_metrics = test_cli.main(
        [path, ckpt, "--eval", "bbox", "segm", "--out", out, "--device", "cpu"])
    assert [r[2] for r in cli_results] == [r[2] for r in results]
    assert cli_metrics["segm_mAP"] == metrics["segm_mAP"]
    segm = json.loads(open(out.replace(".bbox.json", ".segm.json")).read())
    assert segm and all("counts" in d["segmentation"] for d in segm)


# -- slow: the whole predict, the loss on the detector, an epoch ---------------------

@pytest.mark.slow
def test_yolact_full_predict_matches_jax(pair):
    det, var, port = pair
    x = U.images(9, B, HW)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    want = j_yolact.yolact_full_predict(det, var, jnp.asarray(x),
                                        scale_factors=jnp.asarray(sfs))
    got = yolact.yolact_full_predict(port, U.nchw(x), scale_factors=t(sfs))
    valid = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(want[1])[valid])
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid],
                               rtol=1e-5, atol=1e-4)
    assert float((got[3] - t(want[3])).abs().max()) < 1e-4


@pytest.mark.slow
def test_yolact_loss_on_the_detector_matches_jax(pair):
    det, var, port = pair
    batch = _loss_batch(10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, b_: j_yolact.yolact_loss(
        det.bbox_head, det.apply(v, b_["images"], training=True), b_))(var, jb)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = detector_loss(copy.deepcopy(port).train(), pb)
    for k in ("loss_cls", "loss_bbox", "loss_mask", "loss_segm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k


@pytest.mark.slow
def test_train_detector_on_tiny_coco(coco, tmp_path):
    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.config import Config

    raw = coco_instance_config(Config.fromfile(
        "configs/yolact/yolact_r50_1x8_coco.py").to_dict(), coco)
    raw["model"] = coco80(TINY_YOLACT)
    raw["canvas_hw"] = list(HW)
    raw["data"]["train"]["pipeline"] = copy.deepcopy(Config.fromfile(
        "configs/_base_/datasets/coco_instance.py").train_pipeline)
    for step in raw["data"]["train"]["pipeline"]:
        if step["type"] == "Resize":
            step["img_scale"] = (96, 64)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    raw["data"]["workers_per_gpu"] = 1
    raw.update(runner=dict(type="EpochBasedRunner", max_epochs=1),
               log_config=dict(interval=1),
               evaluation=dict(interval=1, metric=["bbox", "segm"]))
    work = tmp_path / "work"
    train_detector(Config(raw), str(work), device="cpu")
    log = [json.loads(x) for x in (work / "train.log.json").read_text()
           .splitlines()]
    steps = [x for x in log if x.get("mode") == "train"]
    val = [x for x in log if x.get("mode") == "val"]
    assert steps and all(np.isfinite(x[k]) for x in steps
                         for k in ("loss_mask", "loss_segm"))
    assert val and 0.0 <= val[-1]["segm_mAP"] <= 1.0
