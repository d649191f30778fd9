"""The port's PointRend against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_POINT_REND`` (``TINY_MASK_RCNN``'s parts, a 64-wide
``CoarseMaskHead`` of 7x7 logits and a 32-wide 3-FC ``MaskPointHead``; 20
classes), f32:

- the coarse head and the point head through the weight bridge (the
  coarse head's ``fcs.0`` rows and ``fc_logits`` rows permuted, the point
  head's ``Conv1d`` weights): 1e-5 of the largest magnitude;
- ``sample_points`` against ``_sample_chw`` (points past the map too),
  ``point_targets_from_crops`` and ``fine_grained_point_feats``: 1e-5;
- ``uncertain_points_train`` given JAX's threefry draws: the points equal,
  with RoIs whose uncertainty is tied everywhere (all-zero logits) or on
  half the map, where the ties go to the lower index as ``jax.lax.top_k``
  sends them;
- ``point_rend_refine`` on integer coarse logits (their 2x upsamples are
  exact, so ties abound, and at 50 points the top-k has to break them):
  1e-5 of the largest magnitude; and its scatter bit-equal to JAX's
  one-hot blend computed in torch;
- ``point_branch_loss`` given JAX's points, and the mask branch's
  ``loss_mask`` and ``loss_point`` given JAX's samples and draws (JAX's
  mask targets handed to both): 1e-5 relative;
- the loss's keys and gradients (``loss_point`` reaches the point head
  and, through the coarse logits at the points, the coarse head), the
  point draws after the samplers' in ``sampler_draws``;
- ``mask_rcnn_predict``: (B, 100, 28, 28) probabilities in [0, 1] after two
  subdivision steps and 2 NMS launches;
- the weight bridge both ways and an mmdet-keyed ``.pth``;
- both configs of ``configs/point_rend/`` built on the meta device, with
  the JAX package's parameter count for one;
- ``single_device_test`` gives boxes only, as in JAX, and the test CLI
  refuses ``--eval segm``;
- slow: the whole predict against JAX's (eager JAX) and the whole loss
  with JAX's draws and targets.
"""

import copy
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models.detectors import two_stage as j_two
from dsl_tpu.models.roi_heads import point_rend as j_pr
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.roi_heads import point_rend as pr
from dsl_tpu_torch.ops.resize import resize_bilinear
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.synthetic_data import TINY_POINT_REND, coco_instance_config
from test_torch_port_cascade import detector_pair, rel_err
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _feats, _samples, _val_dataset, coco,
    mask_batch)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
NC = 20
# the JAX package's parameter count (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py": 60214912}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_POINT_REND)


def _point_fn(port):
    return lambda fine, cpts: port(fine, stage="point", coarse=cpts)


def _j_point_fn(det, var):
    return lambda fine, cpts: det.apply(var, fine, cpts,
                                        method=det.point_forward)


# -- the heads and the sampling ---------------------------------------------------

def test_coarse_head_matches_jax(pair):
    det, var, port = pair
    x = np.random.RandomState(1).randn(5, 14, 14, 32).astype(np.float32)
    want = det.apply(var, jnp.asarray(x), method=det.mask_forward)
    with torch.no_grad():
        got = port(U.nchw(x), stage="mask")
    assert tuple(got.shape) == (5, NC, 7, 7)
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


def test_point_head_matches_jax(pair):
    det, var, port = pair
    rng = np.random.RandomState(2)
    fine = rng.randn(3, 11, 32).astype(np.float32)
    coarse = rng.randn(3, 11, NC).astype(np.float32)
    want = _j_point_fn(det, var)(jnp.asarray(fine), jnp.asarray(coarse))
    with torch.no_grad():
        got = _point_fn(port)(t(fine), t(coarse))
    assert tuple(got.shape) == (3, 11, NC) and rel_err(got, want) < 1e-5


def test_sample_points_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.randn(4, 7, 9, 6).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (4, 30, 2)).astype(np.float32)
    want = jax.vmap(j_pr._sample_chw)(jnp.asarray(img), jnp.asarray(pts))
    got = pr.sample_points(U.nchw(img), t(pts))
    assert rel_err(got, want) < 1e-6


def test_point_targets_and_fine_features_match_jax():
    rng = np.random.RandomState(4)
    n, p, m = 6, 25, 112
    gx, gy = rng.uniform(0, 60, n), rng.uniform(0, 40, n)
    gt = np.stack([gx, gy, gx + rng.uniform(3, 30, n),
                   gy + rng.uniform(3, 20, n)], 1).astype(np.float32)
    rois = (gt + rng.uniform(-6, 6, (n, 4))).astype(np.float32)
    rel = rng.uniform(0, 1, (n, p, 2)).astype(np.float32)
    crops = (rng.rand(n, m, m) < 0.5).astype(np.uint8)
    # eager: compiled, XLA contracts ``ny * m - 0.5`` into one rounding
    want = j_pr.point_targets_from_crops(
        *(jnp.asarray(a) for a in (crops, gt, rois, rel)))
    got = pr.point_targets_from_crops(t(crops), t(gt), t(rois), t(rel))
    assert float((got - t(want)).abs().max()) < 1e-5
    assert 0 < float(got.mean()) < 1
    p2 = rng.randn(B, 16, 24, 32).astype(np.float32)
    rois_b, rel_b = rois.reshape(B, 3, 4), rel.reshape(B, 3, p, 2)
    want = j_pr.fine_grained_point_feats(
        jnp.asarray(p2), jnp.asarray(rois_b), jnp.asarray(rel_b), stride=4)
    got = pr.fine_grained_point_feats(U.nchw(p2), t(rois_b), t(rel_b),
                                      stride=4)
    assert tuple(got.shape) == (B, 3, p, 32) and rel_err(got, want) < 1e-5


def _jax_point_draws(key, n: int, num_points: int = pr.TRAIN_POINTS):
    """The uniforms ``uncertain_points_train`` draws from ``key``."""
    n_imp = int(pr.IMPORTANCE_RATIO * num_points)
    over = jax.random.uniform(key, (n, int(num_points * pr.OVERSAMPLE_RATIO),
                                    2))
    fill = jax.random.uniform(jax.random.fold_in(key, 1),
                              (n, num_points - n_imp, 2))
    return over, fill


def test_uncertain_points_match_jax_with_ties():
    rng = np.random.RandomState(5)
    n = 5
    coarse = rng.randn(n, 7, 7, NC).astype(np.float32)
    coarse[0] = 0.0                          # every point tied
    coarse[1, :, :4] = 0.0                   # ties on the left of the map
    labels = np.asarray([3, 1, 19, 25, 0])   # 25: past the classes, clipped
    key = jax.random.PRNGKey(7)
    want = j_pr.uncertain_points_train(key, jnp.asarray(coarse),
                                       jnp.asarray(labels), 196)
    over, fill = _jax_point_draws(key, n)
    got = pr.uncertain_points_train(t(over), t(fill), U.nchw(coarse),
                                    t(labels), 196)
    assert tuple(got.shape) == (n, 196, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the all-tied RoI keeps the first 147 oversampled points, in order
    np.testing.assert_array_equal(got[0, :147].numpy(), np.asarray(over[0, :147]))


# -- the test-time subdivision -----------------------------------------------------

def _refine_inputs(seed: int):
    rng = np.random.RandomState(seed)
    coarse = rng.randint(-3, 4, (B, 3, 7, 7, NC)).astype(np.float32)
    p2 = rng.randn(B, 16, 24, 32).astype(np.float32)
    x1, y1 = rng.uniform(0, 60, (B, 3)), rng.uniform(0, 40, (B, 3))
    rois = np.stack([x1, y1, x1 + rng.uniform(4, 30, (B, 3)),
                     y1 + rng.uniform(4, 20, (B, 3))], -1).astype(np.float32)
    labels = rng.randint(0, NC, (B, 3))
    return coarse, p2, rois, labels


@pytest.mark.parametrize("num_points", [50, 196])
def test_refine_matches_jax_given_the_ties(pair, num_points):
    det, var, port = pair
    coarse, p2, rois, labels = _refine_inputs(6)
    want = jax.jit(lambda v, *a: j_pr.point_rend_refine(
        *a, _j_point_fn(det, v), subdivision_steps=2, num_points=num_points,
        stride=4))(var, *(jnp.asarray(a) for a in (coarse, p2, rois, labels)))
    with torch.no_grad():
        got = pr.point_rend_refine(
            t(coarse).permute(0, 1, 4, 2, 3), U.nchw(p2), t(rois), t(labels),
            _point_fn(port), subdivision_steps=2, num_points=num_points,
            stride=4)
    assert tuple(got.shape) == (B, 3, NC, 28, 28)
    assert rel_err(got.permute(0, 1, 3, 4, 2), want) < 1e-5


def test_refine_scatter_is_the_one_hot_blend(pair):
    """One subdivision step: the scatter of the point logits equals JAX's
    blend ``flat * (1 - any(onehot)) + onehot^T @ logits`` bit for bit."""
    port = pair[2]
    coarse, p2, rois, labels = _refine_inputs(7)
    c = t(coarse).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        got = pr.point_rend_refine(c, U.nchw(p2), t(rois), t(labels),
                                   _point_fn(port), subdivision_steps=1,
                                   num_points=60)
        up = resize_bilinear(c, (14, 14))
        sel = torch.gather(up, 2, t(labels)[:, :, None, None, None].expand(
            B, 3, 1, 14, 14))
        _, idx = torch.sort(-sel.reshape(B, 3, 196).abs(), dim=-1,
                            descending=True, stable=True)
        idx = idx[..., :60]
        pts = torch.stack([((idx % 14).float() + 0.5) / 14,
                           ((idx // 14).float() + 0.5) / 14], -1)
        logits = _point_fn(port)(
            pr.fine_grained_point_feats(U.nchw(p2), t(rois), pts),
            pr.sample_points(c.reshape(B * 3, NC, 7, 7),
                             pts.reshape(B * 3, 60, 2)).reshape(B, 3, 60, NC))
        onehot = torch.nn.functional.one_hot(idx, 196).float()   # (B, N, k, HW)
        repl = torch.einsum("bnkh,bnkc->bnch", onehot, logits)
        keep = 1.0 - onehot.sum(2).clamp(0, 1)[:, :, None]
        want = (up.reshape(B, 3, NC, 196) * keep + repl).reshape(got.shape)
    assert torch.equal(got, want)


# -- the loss ---------------------------------------------------------------------

def test_point_branch_loss_matches_jax_given_its_points(pair):
    det, var, port = pair
    batch = mask_batch(8)
    samples = _samples(batch, 8, 16)
    jfeats, pfeats = _feats(pair, 9)
    coarse = np.random.RandomState(10).randn(B * 16, 7, 7, NC).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    rel = j_pr.uncertain_points_train(
        key, jnp.asarray(coarse), jnp.asarray(samples["labels"].reshape(-1)),
        196)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = [jnp.asarray(samples[k]) for k in ("rois", "labels", "assigned",
                                              "is_pos")]
    want = jax.jit(lambda v, f, c, *a: j_two._point_branch_loss(
        det, v, f, c, *a, jb, None, jax.random.PRNGKey(3)))(
        var, jfeats, jnp.asarray(coarse), *args)
    pb = {k: t(v) for k, v in batch.items()}
    got = pr.point_branch_loss(_point_fn(port), pfeats[0],
                               U.nchw(coarse), t(rel),
                               *(t(samples[k]) for k in ("rois", "labels",
                                                         "assigned", "is_pos")),
                               pb, stride=4)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_mask_branch_losses_match_jax_given_its_draws(pair, monkeypatch):
    det, var, port = pair
    batch = mask_batch(11)
    num_samples = 32
    samples = _samples(batch, 11, num_samples)
    jfeats, pfeats = _feats(pair, 12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = {k: jnp.asarray(v) for k, v in samples.items()}
    key = jax.random.PRNGKey(5)
    want_m, _, want_p = jax.jit(lambda v: j_two._mask_branch_loss(
        det, v, jfeats, js, jb, num_samples=num_samples, rng_key=key))(var)
    draws = _jax_point_draws(jax.random.fold_in(key, 11),
                             B * (num_samples // 4))
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v) for k, v in batch.items()}
    got = two_stage.mask_branch_losses(
        port, pfeats, {k: t(v) for k, v in samples.items()}, pb, num_samples,
        tuple(t(d) for d in draws))
    assert set(got) == {"loss_mask", "loss_point"}
    for key_, want in (("loss_mask", want_m), ("loss_point", want_p)):
        assert abs(float(got[key_].detach()) - float(want)) <= 1e-5 * abs(
            float(want)), key_


def test_loss_keys_gradients_and_point_draws(pair):
    port = copy.deepcopy(pair[2]).train()
    batch = mask_batch(13)
    batch["images"] = U.images(13, B, HW)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    loss, log_vars = two_stage.two_stage_loss(port, pb, cur_iter=2)
    assert {"loss_mask", "loss_point"} <= set(log_vars)
    assert np.isfinite(float(log_vars["loss_point"]))
    port.zero_grad()
    log_vars_point = two_stage.two_stage_loss(port, pb, cur_iter=2)[1]
    assert float(log_vars_point["loss_point"]) == float(log_vars["loss_point"])
    loss.backward()
    for name in ("roi_head.point_head.fc_logits.weight",
                 "roi_head.point_head.fcs.0.conv.weight",
                 "roi_head.mask_head.fc_logits.weight"):
        assert float(dict(port.named_parameters())[name].grad.abs().max()) > 0
    # the point draws follow the samplers' from the same generator
    plain = two_stage.sampler_draws(4, B, 50, 30, "cpu")
    draws = two_stage.sampler_draws(4, B, 50, 30, "cpu", points=(8, 588, 49))
    assert torch.equal(plain["rpn"], draws["rpn"])
    assert torch.equal(plain["rcnn"][0], draws["rcnn"][0])
    assert [tuple(d.shape) for d in draws["point"]] == [(8, 588, 2), (8, 49, 2)]
    assert two_stage.point_draw_shape(port, B, 512) == (B * 128, 588, 49)


# -- predict, weights, configs, the test path -------------------------------------

def test_predict_subdivides_to_28(pair, monkeypatch):
    from dsl_tpu_torch.core import nms as nms_mod

    calls = []
    real = nms_mod.nms_keep
    monkeypatch.setattr(nms_mod, "nms_keep",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = U.nchw(U.images(14, B, HW))
    dets, labels, valid, probs = two_stage.mask_rcnn_predict(
        pair[2], x, img_shapes=t([[64, 96], [60, 90]]))
    assert len(calls) == 2 and int(valid.sum()) > 0
    assert tuple(probs.shape) == (B, 100, 28, 28)
    assert bool(((probs >= 0) & (probs <= 1)).all())
    one = two_stage.mask_rcnn_predict(
        pair[2], x, img_shapes=t([[64, 96], [60, 90]]),
        test_cfg=dict(TINY_POINT_REND["test_cfg"], subdivision_steps=1))[3]
    assert tuple(one.shape) == (B, 100, 14, 14)


def test_bridge_and_mmdet_pth_round_trip(pair, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    for head, names in (("mask_head", ("downsample_conv", "fc0", "fc_logits")),
                        ("point_head", ("fc0", "fc2", "fc_logits"))):
        for k in names:
            for leaf in var["params"][head][k]:
                np.testing.assert_array_equal(back["params"][head][k][leaf],
                                              var["params"][head][k][leaf])
    again = flax_to_state_dict(back)
    assert sorted(again) == sorted(k for k in sd
                                   if not k.endswith("num_batches_tracked"))
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k
    assert tuple(sd["roi_head.point_head.fcs.0.conv.weight"].shape) == (
        32, 32 + NC, 1)
    assert tuple(sd["roi_head.point_head.fc_logits.weight"].shape) == (
        NC, 32 + NC, 1)
    assert {"roi_head.mask_head.downsample_conv.conv.weight",
            "roi_head.mask_head.fcs.1.bias",
            "roi_head.mask_head.fc_logits.weight"} <= set(sd)
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_POINT_REND))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/point_rend/*.py")))
def test_the_point_rend_configs_build(config):
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ == "PointRend"
    assert type(det.mask_head).__name__ == "CoarseMaskHead"
    assert det.point_head.num_classes == 80
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for key in ("bbox_head", "mask_head", "point_head"):
        cfg[key]["num_classes"] = 80
    return cfg


def test_single_device_test_gives_boxes_and_the_cli_refuses_segm(coco,
                                                                 tmp_path):
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    port = detector_pair(coco80(TINY_POINT_REND))[2]
    test_cfg = dict(TINY_POINT_REND["test_cfg"],
                    rcnn=dict(TINY_POINT_REND["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    metrics, results = single_device_test(
        port, None, _val_dataset(coco), test_cfg=test_cfg, canvas_hw=HW,
        img_scale=(96, 64), device="cpu", return_results=True)
    assert 0.0 <= metrics["bbox_mAP"] <= 1.0 and "segm_mAP" not in metrics
    assert all(len(r) == 2 for r in results)
    raw = coco_instance_config(Config.fromfile(
        "configs/point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py"
    ).to_dict(), coco)
    raw["model"] = dict(coco80(TINY_POINT_REND), test_cfg=test_cfg)
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_point_rend.py")
    Config(raw).dump(path)
    ckpt = str(tmp_path / "seeded.pth")
    torch.save(port.state_dict(), ckpt)
    with pytest.raises(NotImplementedError, match="gives no masks"):
        test_cli.main([path, ckpt, "--eval", "segm", "--device", "cpu"])


# -- slow: the whole predict and loss ----------------------------------------------

@pytest.mark.slow
def test_point_rend_predict_matches_jax(pair):
    det, var, port = pair
    x = U.images(15, B, HW)
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    want = j_two.mask_rcnn_predict(det, var, jnp.asarray(x),
                                   img_shapes=jnp.asarray(shapes))
    got = two_stage.mask_rcnn_predict(port, U.nchw(x), img_shapes=t(shapes))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    assert float((got[3] - t(want[3])).abs().max()) < 1e-4


@pytest.mark.slow
def test_point_rend_loss_matches_jax(pair, monkeypatch):
    from test_torch_port_two_stage import jax_draws

    det, var, port = pair
    batch = mask_batch(16)
    batch["images"] = U.images(16, B, HW)
    batch["img_shapes"] = np.asarray([[64, 96], [60, 90]], np.float32)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(3, jnp.uint32))
    want = jax.jit(lambda v, b_: j_two.two_stage_loss(det, v, b_,
                                                      rng_key=rng)[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})

    def draws(it, b, a, n, dev, points):
        out = jax_draws(it, b, a, n)
        out["point"] = tuple(t(d) for d in _jax_point_draws(
            jax.random.fold_in(rng, 11), points[0]))
        return out

    monkeypatch.setattr(two_stage, "sampler_draws", draws)
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = two_stage.two_stage_loss(copy.deepcopy(port).train(), pb,
                                      cur_iter=3)
    for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
              "loss_mask", "loss_point"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
