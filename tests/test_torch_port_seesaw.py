"""The port's Seesaw loss and normed mask predictor against the JAX package.

Seeded numpy inputs through each JAX function and its port, f32, on
``synthetic_data.TINY_SEESAW`` (``TINY_MASK_RCNN`` with ``SeesawLoss`` and
the normed mask predictor; 20 classes) and a Seesaw Cascade Mask R-CNN
on ``TINY_CASCADE_MASK_RCNN``'s parts, at 64x96:

- ``seesaw_ce_loss`` (with and without each factor) and ``seesaw_loss``
  (its two losses and the counts it returns), given skewed counts and
  labels with the background: 1e-5 relative, the counts equal;
- ``SeesawCounter`` over three batches, invalid labels among them: equal
  to JAX's counts;
- ``NormedConv2d`` against JAX's ``NormedConv`` (1x1 and 3x3), and the
  normed mask head through the weight bridge: 1e-5 of the largest
  magnitude;
- the bbox head's C + 2 logits, and ``rcnn_bbox_loss``'s ``loss_cls``,
  ``loss_cls_objectness``, ``acc`` and ``loss_bbox`` given the same
  samples and counts: 1e-5 relative, for the Mask R-CNN head and each
  class-agnostic cascade stage;
- the split activation through ``rcnn_decode_nms`` and through the
  cascade's ``cascade_decode_nms`` (the mean of the stages' C + 2
  logits): labels and valid equal, dets within 1e-4 plus 1e-5 of their
  magnitude;
- ``with_seesaw_counts``: each step sees the counts with its own batch's
  valid labels already added; SeesawLoss refused by name under data
  parallelism;
- the counter kept where the JAX package's ``train_detector`` keeps one
  (``dsl_tpu/apis/train.py:140-146`` reads ``detector.bbox_head``): for
  the Seesaw Mask R-CNN, not for the Seesaw cascade (it has
  ``bbox_heads``), which trains on counts of one in both packages;
- the weight bridge both ways; an mmdet ``.pth`` with the normed
  predictor's bias refused naming the key;
- every config of ``configs/seesaw_loss/`` built on the meta device, with
  the JAX package's parameter counts for two;
- slow: the whole loss with JAX's draws, targets and counts against
  JAX's (1e-5 relative); the Seesaw cascade's whole loss without counts
  against JAX's, which reads ones (1e-5 relative); one epoch of
  ``train_detector`` with the synthetic COCO instance set, whose counter
  ends at one plus the valid GT labels fed.
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
from dsl_tpu.core import losses as JL
from dsl_tpu.models.detectors import cascade_rcnn as j_cas
from dsl_tpu.models.detectors import two_stage as j_two
from dsl_tpu.models.layers import NormedConv
from dsl_tpu.models.roi_heads import standard_roi_head as j_roi
from dsl_tpu_torch.apis import train as train_api
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors import cascade_rcnn, two_stage
from dsl_tpu_torch.models.layers import NormedConv2d
from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_CASCADE_MASK_RCNN, TINY_SEESAW, coco_instance_config)
from test_torch_port_cascade import (
    assert_boxes_close, detector_pair, random_boxes, rel_err)
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    _samples, coco, mask_batch)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
NC = 20
SEESAW = dict(type="SeesawLoss", p=0.8, q=2.0, loss_weight=1.0)
TINY_SEESAW_CASCADE = dict(
    TINY_CASCADE_MASK_RCNN,
    bbox_heads=[dict(h, loss_cls=SEESAW)
                for h in TINY_CASCADE_MASK_RCNN["bbox_heads"]],
    mask_head=TINY_SEESAW["mask_head"])
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {
    "seesaw_loss/mask_rcnn_r50_fpn_random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1.py":
        50152656,
    "seesaw_loss/cascade_mask_rcnn_r101_fpn_random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1.py":
        94773882}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_SEESAW)


@pytest.fixture(scope="module")
def cascade_pair():
    return detector_pair(TINY_SEESAW_CASCADE)


def _close(got, want, rel: float = 1e-5):
    assert abs(float(got) - float(want)) <= rel * max(abs(float(want)), 1e-12)


def _counts(seed: int, nc: int = NC) -> np.ndarray:
    """Skewed running counts: rare and frequent classes, a background."""
    rng = np.random.RandomState(seed)
    return np.exp(rng.uniform(0, 7, nc + 1)).round().astype(np.float32)


# -- the losses -------------------------------------------------------------------

@pytest.mark.parametrize("p,q", [(0.8, 2.0), (0.0, 2.0), (0.8, 0.0)])
def test_seesaw_ce_loss_matches_jax(p, q):
    rng = np.random.RandomState(1)
    logits = (rng.randn(40, NC) * 3).astype(np.float32)
    labels = rng.randint(0, NC, 40)
    weight = (rng.rand(40) < 0.8).astype(np.float32)
    cum = _counts(2)[:NC]
    want = JL.seesaw_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.asarray(cum), p=p, q=q,
                             weight=jnp.asarray(weight), avg_factor=30.0)
    got = L.seesaw_ce_loss(t(logits), t(labels), t(cum), p=p, q=q,
                           weight=t(weight), avg_factor=30.0)
    _close(got, want)


def test_seesaw_loss_and_counter_match_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(64, NC + 2) * 2).astype(np.float32)
    labels = np.where(rng.rand(64) < 0.4, rng.randint(0, NC, 64), NC)
    weight = (rng.rand(64) < 0.9).astype(np.float32)
    cum = _counts(4)
    want = JL.seesaw_loss(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(cum), NC, weight=jnp.asarray(weight),
                          avg_factor=50.0)
    got = L.seesaw_loss(t(logits), t(labels), t(cum), NC, weight=t(weight),
                        avg_factor=50.0)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    with pytest.raises(ValueError, match="C \\+ 2"):
        L.seesaw_loss(t(logits[:, :-1]), t(labels), t(cum), NC)
    jc, pc = JL.SeesawCounter(NC), L.SeesawCounter(NC)
    for seed in range(3):
        r = np.random.RandomState(seed)
        gl = r.randint(0, NC, (B, 7))
        gv = r.rand(B, 7) < 0.6
        jc.update(gl, gv)
        pc.update(t(gl), t(gv))
    np.testing.assert_array_equal(pc.counts.numpy(), jc.counts)


def test_normed_conv_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 6, 7, 16).astype(np.float32)
    for k in (1, 3):
        kernel = rng.randn(k, k, 16, 10).astype(np.float32)
        want = NormedConv(10, kernel_size=k, tempearture=20.0).apply(
            {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
        conv = NormedConv2d(16, 10, k, 20.0)
        with torch.no_grad():
            conv.weight.copy_(t(kernel.transpose(3, 2, 0, 1)))
            got = conv(U.nchw(x))
        assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


def test_normed_mask_head_matches_jax(pair):
    det, var, port = pair
    x = np.random.RandomState(6).randn(5, 14, 14, 32).astype(np.float32)
    want = det.apply(var, jnp.asarray(x), method=det.mask_forward)
    with torch.no_grad():
        got = port(U.nchw(x), stage="mask")
    assert isinstance(port.mask_head.conv_logits, NormedConv2d)
    assert rel_err(got.permute(0, 2, 3, 1), want) < 1e-5


# -- the bbox heads ----------------------------------------------------------------

def _roi_samples(seed: int, n: int, batch: dict) -> dict:
    rng = np.random.RandomState(seed)
    s = _samples(batch, seed, n)
    s["valid"] = rng.rand(B, n) < 0.9
    return s


def _port(samples: dict) -> dict:
    """The samples as the port's sampler gives them (int64 indices)."""
    return {k: t(v, torch.int64 if v.dtype.kind == "i" else None)
            for k, v in samples.items()}


@pytest.mark.parametrize("stage", [None, 0, 1, 2])
def test_rcnn_bbox_loss_matches_jax(pair, cascade_pair, stage):
    if stage is None:
        jh, ph = pair[0].bbox_head, pair[2].bbox_head
    else:
        jh = cascade_pair[0].bbox_heads[stage]
        ph = cascade_pair[2].bbox_heads[stage]
    assert ph.fc_cls.out_features == NC + 2
    batch = mask_batch(7)
    samples = _roi_samples(7, 24, batch)
    rng = np.random.RandomState(8)
    logits = (rng.randn(B * 24, NC + 2) * 2).astype(np.float32)
    reg = (rng.randn(B * 24, 4 if ph.reg_class_agnostic else 4 * NC) * 0.3
           ).astype(np.float32)
    cum = _counts(9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["cum_samples"] = jnp.asarray(cum)
    want = j_roi.rcnn_bbox_loss(jh, jnp.asarray(logits), jnp.asarray(reg),
                                {k: jnp.asarray(v) for k, v in samples.items()},
                                jb)
    pb = {k: t(v) for k, v in batch.items()}
    pb["cum_samples"] = t(cum)
    got = roi.rcnn_bbox_loss(ph, t(logits), t(reg), _port(samples), pb)
    assert list(got) == list(want) == ["loss_cls", "acc",
                                       "loss_cls_objectness", "loss_bbox"]
    for k in want:
        _close(got[k], want[k])
    # without counts the loss reads ones, as in JAX
    del jb["cum_samples"], pb["cum_samples"]
    _close(roi.rcnn_bbox_loss(ph, t(logits), t(reg), _port(samples), pb)[
        "loss_cls"], j_roi.rcnn_bbox_loss(
        jh, jnp.asarray(logits), jnp.asarray(reg),
        {k: jnp.asarray(v) for k, v in samples.items()}, jb)["loss_cls"])


def test_split_activation_decode_matches_jax(pair):
    jh, ph = pair[0].bbox_head, pair[2].bbox_head
    rng = np.random.RandomState(10)
    props = random_boxes(rng, (B, 50))
    pvalid = rng.rand(B, 50) < 0.9
    logits = rng.randn(B * 50, NC + 2).astype(np.float32)
    logits[:, :5] += 3.0
    logits[:, NC] += 2.0                     # positive objectness
    reg = (0.3 * rng.randn(B * 50, 4 * NC)).astype(np.float32)
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    sfs = np.asarray([[1.5] * 4, [1.0] * 4], np.float32)
    want = jax.jit(lambda *a: j_roi.rcnn_decode_nms(
        jh, *a[:4], img_shapes=a[4], scale_factors=a[5]))(
        *(jnp.asarray(a) for a in (logits, reg, props, pvalid, shapes, sfs)))
    got = roi.rcnn_decode_nms(ph, t(logits), t(reg), t(props), t(pvalid),
                              img_shapes=t(shapes), scale_factors=t(sfs))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    assert int(got[2].sum()) > 50
    sc = torch.softmax(t(logits[:, :NC]), -1) * torch.softmax(
        t(logits[:, NC:]), -1)[:, :1]
    assert torch.equal(roi.split_scores(ph, t(logits)), sc)


def test_seesaw_cascade_decode_matches_jax(cascade_pair):
    det, _, port = cascade_pair
    rng = np.random.RandomState(11)
    props = random_boxes(rng, (B, 60))
    pvalid = rng.rand(B, 60) < 0.9
    outs = []
    for _ in range(3):
        logits = rng.randn(B * 60, NC + 2).astype(np.float32)
        logits[:, :6] += 2.0
        logits[:, NC] += 2.0
        outs.append((logits, 0.3 * rng.randn(B * 60, 4).astype(np.float32)))
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    test_cfg = TINY_SEESAW_CASCADE["test_cfg"]
    want = jax.jit(lambda p_, v_, s_, o_: j_cas.cascade_decode_nms(
        det.bbox_heads, lambda i, _: o_[i], p_, v_, img_shapes=s_,
        test_cfg=test_cfg))(
        jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(shapes),
        [tuple(jnp.asarray(a) for a in o) for o in outs])
    got = cascade_rcnn.cascade_decode_nms(
        port.bbox_heads, lambda i, _: tuple(t(a) for a in outs[i]), t(props),
        t(pvalid), img_shapes=t(shapes), test_cfg=test_cfg)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_boxes_close(got[0], want[0], rtol=1e-5)
    assert int(got[2].sum()) > 50


# -- the train loop, weights, configs -----------------------------------------------

def test_counts_reach_each_step_with_its_own_labels():
    seen = []

    def step(state, batch, mark=None):
        seen.append(batch["cum_samples"].clone())
        return {}

    wrapped = train_api.with_seesaw_counts(step, NC, "cpu")
    want = np.ones(NC + 1, np.float32)
    for seed in range(3):
        r = np.random.RandomState(seed)
        gl, gv = r.randint(0, NC, (B, 6)), r.rand(B, 6) < 0.5
        wrapped(None, dict(gt_labels=t(gl), gt_valid=t(gv)))
        np.add.at(want, gl[gv], 1.0)
        np.testing.assert_array_equal(seen[-1].numpy(), want)
    np.testing.assert_array_equal(wrapped.counter.counts.numpy(), want)
    cfg = Config(dict(model=copy.deepcopy(TINY_SEESAW)))
    assert train_api._seesaw_classes(cfg.model) == NC
    train_api._refuse_unported(cfg)           # one process: trains
    with pytest.raises(NotImplementedError, match="SeesawLoss"):
        train_api._refuse_unported(cfg, group=object())


@pytest.mark.parametrize("cfg", [TINY_SEESAW, TINY_SEESAW_CASCADE],
                         ids=["mask_rcnn", "cascade"])
def test_the_counter_is_kept_where_jax_keeps_one(cfg):
    from dsl_tpu.models import build_detector as j_build

    # the head JAX's train_detector reads (a flax module: nothing compiles)
    head = getattr(j_build(copy.deepcopy(cfg)), "bbox_head", None)
    counts = dict(getattr(head, "loss_cls", None) or {}).get(
        "type") == "SeesawLoss"
    assert counts == (cfg is TINY_SEESAW)
    assert train_api._seesaw_classes(cfg) == (head.num_classes if counts
                                              else None)
    # data parallelism is refused for the configs that count; the cascade
    # meets the two-stage detectors' refusal instead
    with pytest.raises(NotImplementedError,
                       match="SeesawLoss" if counts else "two-stage"):
        train_api._refuse_unported(Config(dict(model=copy.deepcopy(cfg))),
                                   group=object())


def test_bridge_round_trip_and_mmdet_bias_refused(pair, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    assert "roi_head.mask_head.conv_logits.bias" not in sd
    assert tuple(sd["roi_head.bbox_head.fc_cls.weight"].shape) == (NC + 2, 64)
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    np.testing.assert_array_equal(
        back["params"]["mask_head"]["conv_logits"]["kernel"],
        var["params"]["mask_head"]["conv_logits"]["kernel"])
    again = flax_to_state_dict(back)
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k
    mmdet = dict(sd, **{"roi_head.mask_head.conv_logits.bias":
                        torch.zeros(NC)})
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": mmdet}, path)
    with pytest.raises(KeyError, match="conv_logits.bias"):
        load_torch_detector(str(path), build_detector(copy.deepcopy(TINY_SEESAW)))


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/seesaw_loss/*.py")))
def test_the_seesaw_configs_build(config):
    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    heads = getattr(det, "bbox_heads", None) or [det.bbox_head]
    assert all(h.fc_cls.out_features == 1203 + 2 for h in heads)
    assert isinstance(det.mask_head.conv_logits, NormedConv2d) == (
        "normed_mask" in config)
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


# -- slow: the whole loss, an epoch ------------------------------------------------

@pytest.mark.slow
def test_seesaw_loss_matches_jax(pair, monkeypatch):
    from test_torch_port_two_stage import jax_draws

    det, var, port = pair
    batch = mask_batch(12)
    batch["images"] = U.images(12, B, HW)
    batch["img_shapes"] = np.asarray([[64, 96], [60, 90]], np.float32)
    batch["cum_samples"] = _counts(13)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(3, jnp.uint32))
    want = jax.jit(lambda v, b_: j_two.two_stage_loss(det, v, b_,
                                                      rng_key=rng)[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(two_stage, "sampler_draws",
                        lambda it, b, a, n, dev: jax_draws(it, b, a, n))
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = two_stage.two_stage_loss(copy.deepcopy(port).train(), pb,
                                      cur_iter=3)
    for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
              "loss_cls_objectness", "loss_bbox", "loss_mask"):
        _close(got[k], want[k])


@pytest.mark.slow
def test_seesaw_cascade_loss_without_counts_matches_jax(cascade_pair,
                                                        monkeypatch):
    """The cascade's whole loss with no ``cum_samples``, as both packages'
    ``train_detector`` run it: each stage's SeesawLoss on counts of one."""
    from test_torch_port_cascade import jax_cascade_draws

    det, var, port = cascade_pair
    batch = mask_batch(14)
    batch["images"] = U.images(14, B, HW)
    assert "cum_samples" not in batch
    want = jax.jit(lambda v, b_: j_cas.cascade_rcnn_loss(
        det, v, b_, rng_key=jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.asarray(4, jnp.uint32)))[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(two_stage, "sampler_draws",
                        lambda it, b, a, n, dev, stages=None:
                        jax_cascade_draws(it, b, a, n, stages))
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = cascade_rcnn.cascade_rcnn_loss(copy.deepcopy(port).train(), pb,
                                            cur_iter=4)
    assert {f"s{i}.loss_cls_objectness" for i in range(3)} <= set(want)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v)


@pytest.mark.slow
def test_train_detector_counts_the_labels_it_was_fed(coco, tmp_path,
                                                     monkeypatch):
    from dsl_tpu_torch.apis import train_detector

    fed = []
    real = train_api.with_seesaw_counts

    def recording(step, nc, device):
        wrapped = real(step, nc, device)

        def inner(state, batch, **kw):
            fed.append(batch["gt_labels"][batch["gt_valid"]].clone())
            return wrapped(state, batch, **kw)

        inner.counter = wrapped.counter
        fed.append(inner)
        return inner

    monkeypatch.setattr(train_api, "with_seesaw_counts", recording)
    raw = coco_instance_config(Config.fromfile(
        "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py").to_dict(), coco)
    raw["model"] = copy.deepcopy(TINY_SEESAW)
    for key in ("bbox_head", "mask_head"):
        raw["model"][key]["num_classes"] = 80
    raw["canvas_hw"] = list(HW)
    raw["data"]["train"]["pipeline"] = copy.deepcopy(Config.fromfile(
        "configs/_base_/datasets/coco_instance.py").train_pipeline)
    for step in raw["data"]["train"]["pipeline"]:
        if step["type"] == "Resize":
            step["img_scale"] = (96, 64)
    raw["data"]["workers_per_gpu"] = 1
    raw.update(runner=dict(type="EpochBasedRunner", max_epochs=1),
               log_config=dict(interval=1))
    raw.pop("evaluation", None)
    work = tmp_path / "work"
    train_detector(Config(raw), str(work), device="cpu")
    wrapper, labels = fed[0], torch.cat(fed[1:])
    want = torch.ones(81).index_add_(0, labels.long(), torch.ones(len(labels)))
    assert torch.equal(wrapper.counter.counts, want) and len(labels) > 0
    steps = [json.loads(x) for x in (work / "train.log.json").read_text()
             .splitlines() if '"train"' in x]
    assert steps and all(np.isfinite(s["loss_cls_objectness"]) for s in steps)
