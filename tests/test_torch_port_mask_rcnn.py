"""The port's Mask R-CNN (FPN and C4) against the JAX package, on the CPU.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_MASK_RCNN`` (``TINY_FASTER_RCNN`` with a 2-conv,
32-channel mask head; 20 classes) or the tiny C4 below (ResNet-18 caffe
C4, a 2-block shared head of stage 1), f32:

- the mask head's transposed conv alone through the weight bridge (flax's
  ``ConvTranspose`` flips its kernel), then ``FCNMaskHead``: 1e-5 of the
  largest magnitude;
- ``select_positive_rois``: equal; ``mask_targets_from_crops`` on JAX's
  inputs: equal but at pixels whose JAX RoIAlign value lies within
  ``TIE`` of 0.5 (the two RoIAligns sum in other orders; counted);
  ``loss_mask`` (``two_stage.mask_branch_losses``) given the same samples
  (the port's samplers draw otherwise than JAX's, so both packages are
  handed one sampler output) and the same features: 1e-5 relative, FPN
  and C4;
- ``paste_masks``: equal but at pixels whose OpenCV value lies within
  ``PASTE_ULPS`` ulps of 0.5 (the float resize past 8x; counted);
- ``mask_logits_for_boxes`` through a small ``jax.jit`` at the module's
  level, on the same features and boxes: 1e-5, and the class
  probabilities 1e-5;
- the C4 parts (``ResLayerSharedHead``, ``BBoxHeadAvgPool``): 1e-5;
- the weight bridge both ways and an mmdet-keyed ``.pth`` (mmdet's
  ``roi_head.mask_head.convs.i.conv`` / ``upsample`` / ``conv_logits``,
  ``roi_head.shared_head.layer4.i``) loaded by ``load_torch_detector``;
- every ``configs/mask_rcnn/`` config and the Faster R-CNN C4 build, with
  the JAX package's parameter counts for three;
- ``single_device_test`` with ``segm``, ``tta_test_masks``, the test
  CLI's ``--eval bbox segm`` and a refusal of ``--eval segm`` without
  masks, on a tiny COCO instance set;
- slow: the whole ``mask_rcnn_predict``, ``single_device_test`` with
  segm and ``tta_test_masks`` against JAX's (eager JAX; about 10-20 s
  each; a pasted pixel may differ only where OpenCV's resize of JAX's
  probabilities lies within ``PASTE_ULPS`` ulps of 0.5, counted; the
  metrics 1e-12 where the masks are equal), and one epoch of
  ``train_detector`` on the tiny Mask R-CNN (``loss_mask`` logged).
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
from dsl_tpu.models.detectors import two_stage as j_two
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.models.roi_heads import mask_head as j_mask
from dsl_tpu.ops.roi_align import roi_align as j_roi_align
from dsl_tpu_torch.core.masks import decode_rle
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.roi_heads import mask_head
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_MASK_RCNN, coco_instance_config, make_coco_instance_dir)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
K = 6
TIE = 1e-6          # a target pixel may flip where JAX's value is this near 0.5
PASTE_ULPS = 32     # the float resize past an 8x upscale (image_ops)
TINY_MASK_RCNN_C4 = dict(
    type="MaskRCNNC4",
    backbone=dict(type="ResNet", depth=18, style="caffe", out_indices=(2,),
                  frozen_stages=1),
    neck=dict(type="IdentityNeck"),
    rpn_head=dict(type="RPNHead", in_channels=256, feat_channels=32,
                  strides=[16]),
    shared_head=dict(type="ResLayerSharedHead", depth=18, stage=1,
                     style="caffe"),
    bbox_head=dict(type="BBoxHeadAvgPool", num_classes=20, in_channels=256,
                   roi_size=14),
    mask_head=dict(type="FCNMaskHead", num_classes=20, in_channels=512,
                   conv_out_channels=32, num_convs=0, roi_size=14),
    test_cfg=TINY_MASK_RCNN["test_cfg"])
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py": 44396336,
           "mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py": 63017008,
           "mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py": 50865968,
           "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py": 48748000}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def detector_pair(cfg: dict, seed: int = 0):
    """The JAX detector, its seeded variables (every subtree) and the
    port's detector with them, in eval mode."""
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda r, x: init_detector_variables(det, r, x),
                            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    var = {k: U._plain(v) for k, v in fill_variables(dict(shapes), seed).items()}
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_MASK_RCNN)


@pytest.fixture(scope="module")
def pair_c4():
    return detector_pair(TINY_MASK_RCNN_C4)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-12))


def test_deconv_through_the_bridge_is_flax():
    import flax.linen as nn

    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 7, 6).astype(np.float32)
    mod = nn.ConvTranspose(4, (2, 2), strides=(2, 2), name="upsample")
    var = {"params": {"mask_head": {
        "upsample": {"kernel": rng.randn(2, 2, 6, 4).astype(np.float32),
                     "bias": rng.randn(4).astype(np.float32)}}}}
    want = mod.apply({"params": var["params"]["mask_head"]["upsample"]},
                     jnp.asarray(x))
    sd = flax_to_state_dict(var)
    deconv = torch.nn.ConvTranspose2d(6, 4, 2, stride=2)
    deconv.load_state_dict({"weight": sd["roi_head.mask_head.upsample.weight"],
                            "bias": sd["roi_head.mask_head.upsample.bias"]})
    got = deconv(U.nchw(x)).permute(0, 2, 3, 1)
    assert rel_err(got, want) < 1e-5
    back = state_dict_to_flax(sd)["params"]["mask_head"]["upsample"]["kernel"]
    np.testing.assert_array_equal(back, var["params"]["mask_head"]["upsample"]
                                  ["kernel"])


def test_fcn_mask_head_matches_jax(pair):
    det, var, port = pair
    x = np.random.RandomState(1).randn(5, 14, 14, 32).astype(np.float32)
    want = det.apply(var, jnp.asarray(x), method=det.mask_forward)
    got = port(U.nchw(x), stage="mask").permute(0, 2, 3, 1)
    assert got.shape == (5, 28, 28, 20) and rel_err(got, want) < 1e-5


def test_c4_parts_match_jax(pair_c4):
    det, var, port = pair_c4
    x = np.random.RandomState(2).randn(4, 14, 14, 256).astype(np.float32)
    want = det.apply(var, jnp.asarray(x), method=det.roi_forward)
    got = port(U.nchw(x), stage="roi")
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-5
    want = det.apply(var, jnp.asarray(x), method=det.mask_forward)
    got = port(U.nchw(x), stage="mask").permute(0, 2, 3, 1)
    assert got.shape == (4, 14, 14, 20) and rel_err(got, want) < 1e-5


def _feats(pair, seed: int):
    """Random FPN levels (or the C4 level) of the detector's shapes: JAX's
    NHWC list and the port's NCHW one."""
    _, _, port = pair
    with torch.no_grad():
        shapes = [f.shape for f in port(torch.zeros((B, 3, *HW)))[0]]
    rng = np.random.RandomState(seed)
    levels = [rng.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(np.transpose(f, (0, 2, 3, 1))) for f in levels],
            [torch.from_numpy(f) for f in levels])


def _crops(rng, k: int, m: int = 112) -> np.ndarray:
    """(K, M, M) binary crops: an ellipse each, off-centre."""
    yy, xx = np.mgrid[:m, :m] + 0.5
    out = []
    for _ in range(k):
        cx, cy = rng.uniform(0.3, 0.7, 2) * m
        rx, ry = rng.uniform(0.2, 0.5, 2) * m
        out.append(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1)
    return np.stack(out).astype(np.uint8)


def mask_batch(seed: int, num_classes: int = 20) -> dict:
    rng = np.random.RandomState(seed)
    h, w = HW
    gtb = np.zeros((B, K, 4), np.float32)
    n_gt = (3, 5)
    for i, n in enumerate(n_gt):
        for j in range(n):
            bw, bh = rng.randint(6, 60), rng.randint(6, 40)
            x1, y1 = rng.randint(0, w - bw + 1), rng.randint(0, h - bh + 1)
            gtb[i, j] = (x1, y1, x1 + bw, y1 + bh)
    return dict(gt_bboxes=gtb,
                gt_labels=rng.randint(0, num_classes, (B, K)).astype(np.int32),
                gt_valid=np.arange(K)[None] < np.asarray(n_gt)[:, None],
                gt_mask_crops=np.stack([_crops(rng, K) for _ in range(B)]),
                img_shapes=np.asarray([[64, 96], [60, 90]], np.float32))


def _proposals(seed: int, batch: dict, p: int = 40):
    """Jittered GT boxes and random boxes, so that many are positive."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, p, 4), np.float32)
    for i in range(B):
        gt = batch["gt_bboxes"][i][batch["gt_valid"][i]]
        for j in range(p):
            if j % 2 and len(gt):
                g = gt[j % len(gt)]
                s = np.r_[g[2:] - g[:2], g[2:] - g[:2]]
                out[i, j] = g + rng.uniform(-0.2, 0.2, 4) * s
            else:
                x1, y1 = rng.uniform(0, 80), rng.uniform(0, 50)
                out[i, j] = (x1, y1, x1 + rng.uniform(4, 40),
                             y1 + rng.uniform(4, 30))
    return out, np.ones((B, p), bool)


def _samples(batch, seed: int, num_samples: int) -> dict:
    """Sampler output in both packages' layout (rois, labels, assigned,
    valid, is_pos; (B, S)): the jittered GT boxes positive, assigned to
    their GT, the random ones negative; fed alike to both packages' mask
    branch."""
    props, _ = _proposals(seed, batch, num_samples)
    is_pos = np.zeros((B, num_samples), bool)
    is_pos[:, 1::2] = batch["gt_valid"].any(1)[:, None]
    n_gt = batch["gt_valid"].sum(1)
    assigned = np.where(is_pos, np.arange(num_samples)[None] % np.maximum(
        n_gt, 1)[:, None], -1)
    labels = np.where(is_pos, np.take_along_axis(
        batch["gt_labels"], np.maximum(assigned, 0), 1), 20)
    return dict(rois=props, labels=labels.astype(np.int32),
                assigned=assigned.astype(np.int32),
                valid=np.ones((B, num_samples), bool), is_pos=is_pos)


def test_select_positive_rois_is_jax():
    rng = np.random.RandomState(4)
    rois = rng.rand(B, 12, 4).astype(np.float32)
    labels = rng.randint(0, 5, (B, 12))
    assigned = rng.randint(-1, 4, (B, 12))
    is_pos = rng.rand(B, 12) < 0.4
    want = j_mask.select_positive_rois(*(jnp.asarray(a) for a in (
        rois, labels, assigned, is_pos)), 5)
    got = mask_head.select_positive_rois(t(rois), t(labels), t(assigned),
                                         t(is_pos), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(2))
def test_mask_targets_match_jax_up_to_counted_ties(seed):
    rng = np.random.RandomState(10 + seed)
    batch = mask_batch(seed)
    n = 48
    rois = np.concatenate([_proposals(seed, batch, n // 2)[0].reshape(-1, 4)])
    bidx = np.repeat(np.arange(B), n // 2)
    assigned = rng.randint(-1, K, n)
    args = (batch["gt_mask_crops"], batch["gt_bboxes"], rois, bidx, assigned)
    want = np.asarray(j_mask.mask_targets_from_crops(
        *(jnp.asarray(a) for a in args), mask_size=28))
    got = mask_head.mask_targets_from_crops(
        *(t(a) for a in args[:3]), t(bidx, torch.int64),
        t(assigned, torch.int64), mask_size=28).numpy()
    diff = got != want
    if diff.any():
        # JAX's value before the threshold, as its function computes it
        b_, k_, m, _ = batch["gt_mask_crops"].shape
        crops = np.pad(batch["gt_mask_crops"].reshape(b_ * k_, m, m, 1)
                       .astype(np.float32), ((0, 0), (1, 1), (1, 1), (0, 0)))
        ci = bidx * k_ + np.clip(assigned, 0, k_ - 1)
        gt = batch["gt_bboxes"].reshape(-1, 4)[ci]
        gw = np.maximum(gt[:, 2] - gt[:, 0], 1.0)
        gh = np.maximum(gt[:, 3] - gt[:, 1], 1.0)
        big = 4.0 * m
        c = [np.clip((rois[:, i] - gt[:, i % 2]) * (m / s), -big, big) + 1.0
             for i, s in ((0, gw), (1, gh), (2, gw), (3, gh))]
        flat = np.stack([ci.astype(np.float32), *c], 1).astype(np.float32)
        raw = np.asarray(j_roi_align(jnp.asarray(crops), jnp.asarray(flat),
                                     out_size=(28, 28), spatial_scale=1.0,
                                     sampling_ratio=2))[..., 0]
        assert (np.abs(raw[diff] - 0.5) <= TIE).all()
    print(f"mask targets: {int(diff.sum())} of {diff.size} pixels differ, "
          f"each within {TIE} of 0.5")


@pytest.mark.parametrize("which", ["fpn", "c4"])
def test_loss_mask_matches_jax_given_its_samples(which, pair, pair_c4,
                                                monkeypatch):
    """The branch's loss on the same samples and features. A flipped
    target pixel moves the loss by |logit| / (S^2 num_pos), more than 1e-5
    of it, so the port's branch is handed JAX's targets (its own are held
    to JAX's, ties aside, above) and their differing pixels are counted."""
    det, var, port = pair if which == "fpn" else pair_c4
    flipped = []

    def jax_targets(crops, gtb, rois, bidx, assigned, mask_size):
        own = mask_head.mask_targets_from_crops(crops, gtb, rois, bidx,
                                                assigned, mask_size)
        want = U.jax_mask_targets(crops, gtb, rois, bidx, assigned,
                                  mask_size)
        flipped.append(int((own != want).sum()))
        return want

    monkeypatch.setattr(two_stage, "mask_targets_from_crops", jax_targets)
    batch = mask_batch(3)
    num_samples = 32
    samples = _samples(batch, 3, num_samples)
    jfeats, pfeats = _feats((det, var, port), 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, f, smp, b: j_two._mask_branch_loss(
        det, v, f, smp, b, num_samples=num_samples)[0])(
        var, jfeats, {k: jnp.asarray(v) for k, v in samples.items()}, jb)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    got = two_stage.mask_branch_losses(
        port, pfeats, {k: t(v) for k, v in samples.items()}, pb,
        num_samples)["loss_mask"]
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert int(samples["is_pos"].sum()) > 4
    print(f"loss_mask ({which}): {flipped[0]} target pixels differ (ties)")


def paste_flips(got: np.ndarray, want: np.ndarray, probs, boxes) -> int:
    """The count of pixels where the port's pasted masks ``got`` (N, H, W)
    differ from the JAX package's ``want``, each asserted to lie in its
    box's window where OpenCV's resize of JAX's 28x28 ``probs`` is within
    ``PASTE_ULPS`` ulps of 0.5 (``boxes``: the paste's, original frame)."""
    import cv2

    diff = got != want
    h, w = want.shape[1:]
    for i in np.unique(np.nonzero(diff)[0]):
        bx1, by1, bx2, by2 = mask_head._box_slice(boxes[i], h, w)
        ref = cv2.resize(np.asarray(probs[i], np.float32),
                         (bx2 - bx1, by2 - by1), interpolation=cv2.INTER_LINEAR)
        d = diff[i, by1:by2, bx1:bx2]
        assert diff[i].sum() == d.sum()
        ulps = (np.abs(ref[d].astype(np.float64) - 0.5)
                / np.spacing(np.float32(0.5)))
        assert (ulps <= PASTE_ULPS).all(), float(ulps.max())
    return int(diff.sum())


def test_paste_masks_follows_the_stated_rule():
    """28x28 probabilities pasted at boxes of 4 to 400 pixels (upscales up
    to 14x) into 300x420: equal to the JAX package's paste but at pixels
    where OpenCV's value lies within ``PASTE_ULPS`` ulps of 0.5."""
    rng = np.random.RandomState(6)
    n, h, w = 24, 300, 420
    probs = rng.rand(n, 28, 28).astype(np.float32)
    probs[::3] = np.round(probs[::3] * 4) / 4            # values at 0.5 too
    x1, y1 = rng.uniform(-10, w - 20, n), rng.uniform(-10, h - 20, n)
    side = np.exp(rng.uniform(np.log(4), np.log(400), (n, 2)))
    boxes = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1],
                      rng.rand(n)], 1).astype(np.float32)
    want = j_mask.paste_masks(probs, boxes, h, w)
    got = mask_head.paste_masks(torch.from_numpy(probs), boxes, h, w).numpy()
    flips = paste_flips(got, want, probs, boxes)
    print(f"paste: {flips} of {want.size} pixels differ, each within "
          f"{PASTE_ULPS} ulps of 0.5")


@jax.jit
def _j_mask_probs(var, feats, boxes, valid, labels):
    logits = j_two.mask_logits_for_boxes(_J_DET, var, feats, boxes, valid)
    cls = jnp.clip(labels.reshape(-1), 0, _J_DET.mask_head.num_classes - 1)
    probs = jax.nn.sigmoid(jnp.take_along_axis(
        logits, cls[:, None, None, None], axis=-1)[..., 0])
    return logits, probs


_J_DET = j_build(copy.deepcopy(TINY_MASK_RCNN))


def test_mask_logits_for_boxes_matches_jax(pair):
    _, var, port = pair
    jfeats, pfeats = _feats(pair, 7)
    rng = np.random.RandomState(8)
    x1, y1 = rng.uniform(-5, 80, (B, 10)), rng.uniform(-5, 50, (B, 10))
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 60, (B, 10)),
                      y1 + rng.uniform(2, 40, (B, 10))], -1).astype(np.float32)
    valid = rng.rand(B, 10) < 0.8
    labels = rng.randint(0, 20, (B, 10))
    want_l, want_p = _j_mask_probs(var, jfeats, jnp.asarray(boxes),
                                   jnp.asarray(valid), jnp.asarray(labels))
    with torch.no_grad():
        logits = two_stage.mask_logits_for_boxes(port, pfeats, t(boxes),
                                                 t(valid))
        probs = two_stage.class_probs(logits, t(labels), 20)
    assert rel_err(logits.permute(0, 2, 3, 1), want_l) < 1e-5
    assert float((probs - t(want_p)).abs().max()) < 1e-5


def test_mask_rcnn_predict_shapes_and_two_launches(pair, monkeypatch):
    from dsl_tpu_torch.core import nms as nms_mod

    calls = []
    real = nms_mod.nms_keep

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(nms_mod, "nms_keep", counting)
    x = U.nchw(U.images(0, B, HW))
    dets, labels, valid, probs = two_stage.mask_rcnn_predict(
        pair[2], x, img_shapes=t([[64, 96], [64, 96]]))
    assert len(calls) == 2
    assert tuple(probs.shape) == (B, 100, 28, 28)
    assert bool(((probs >= 0) & (probs <= 1)).all())
    # the boxes are two_stage_predict's
    want = two_stage.two_stage_predict(pair[2], x,
                                       img_shapes=t([[64, 96], [64, 96]]))
    assert torch.equal(dets, want[0]) and torch.equal(valid, want[2])


def test_bridge_and_mmdet_pth_round_trip(pair, pair_c4, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    for _, var, port in (pair, pair_c4):
        sd = port.state_dict()
        back = state_dict_to_flax(sd)
        for col in ("params", "batch_stats"):
            assert sorted(back[col]) == sorted(var[col])
        again = flax_to_state_dict(back)
        assert sorted(again) == sorted(k for k in sd
                                       if not k.endswith("num_batches_tracked"))
        for k, v in again.items():
            assert torch.equal(v, sd[k]), k
    keys = set(pair[2].state_dict())
    assert {"roi_head.mask_head.convs.1.conv.weight",
            "roi_head.mask_head.upsample.weight",
            "roi_head.mask_head.conv_logits.bias"} <= keys
    c4 = set(pair_c4[2].state_dict())
    assert {"roi_head.shared_head.layer2.1.conv3.weight",
            "roi_head.shared_head.layer2.0.downsample.0.weight",
            "roi_head.bbox_head.fc_cls.weight"} <= c4
    # an mmdet checkpoint (``module.``-prefixed, under ``state_dict``)
    for _, _, port in (pair, pair_c4):
        path = tmp_path / "mmdet.pth"
        torch.save({"state_dict": {f"module.{k}": v for k, v in
                                   port.state_dict().items()}}, path)
        fresh = build_detector(copy.deepcopy(
            TINY_MASK_RCNN if port is pair[2] else TINY_MASK_RCNN_C4))
        missing, unexpected = load_torch_detector(str(path), fresh)
        assert not missing and not unexpected
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, port.state_dict()[k]), k


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/mask_rcnn/*.py"))
    + ["faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py"])
def test_the_mask_rcnn_configs_build(config):
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ in ("MaskRCNN", "MaskRCNNC4", "FasterRCNNC4")
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


def test_unported_mask_parts_raise():
    # the normed predictor and PointRend are ported (their own files): the
    # predictor builds without a bias, PointRend needs its point head
    det = build_detector(dict(copy.deepcopy(TINY_MASK_RCNN), mask_head=dict(
        TINY_MASK_RCNN["mask_head"],
        predictor_cfg=dict(type="NormedConv2d"))))
    assert not hasattr(det.mask_head.conv_logits, "bias")
    with pytest.raises(TypeError, match="point_head"):
        build_detector(dict(copy.deepcopy(TINY_MASK_RCNN), type="PointRend"))
    for change, match in ((dict(type="PISAMaskRCNN"), "PISAMaskRCNN"),
                          (dict(grid_head=dict(type="GridHead")),
                           "grid_head")):
        with pytest.raises(NotImplementedError, match=match):
            build_detector({**copy.deepcopy(TINY_MASK_RCNN), **change})
    with pytest.raises(TypeError, match="mask_head"):
        build_detector(dict(copy.deepcopy(TINY_MASK_RCNN), type="FasterRCNN"))


# -- the test path on a tiny COCO instance set --------------------------------

MAX_DETS = 10       # detections per image on the test path (quick segm)
TINY_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                 to_rgb=True)
TINY_TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="MultiScaleFlipAug", img_scale=(96, 64), flip=False,
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip"), dict(type="Normalize", **TINY_NORM),
                     dict(type="Pad", size_divisor=32)]),
]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A COCO instance set on small JPEGs (the fixtures shrunk by OpenCV),
    so that the segm evaluation is quick."""
    import cv2
    from torch_port_make_fixtures import FIXTURES, OUT

    root = tmp_path_factory.mktemp("coco")
    sources = []
    for i, name in enumerate(sorted(FIXTURES)):
        h, w = 56 + 4 * i, 88 - 4 * i
        img = cv2.resize(cv2.imread(str(OUT / f"{name}.jpg")), (w, h),
                         interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(root / f"small_{i}.jpg"), img)
        sources.append((str(root / f"small_{i}.jpg"), h, w))
    return make_coco_instance_dir(root / "set", sources, n_train=4, n_val=3,
                                  seed=2)


def _val_dataset(coco, port: bool = True):
    import random

    cfg = dict(type="CocoDataset", ann_file=coco["val"],
               img_prefix=coco["val_images"], pipeline=TINY_TEST_PIPELINE,
               test_mode=True)
    if not port:
        from dsl_tpu.registry import DATASETS, build_from_cfg

        return build_from_cfg(cfg, DATASETS)
    from dsl_tpu_torch.registry import DATASETS, build_from_cfg

    return build_from_cfg({**cfg, "device": "cpu",
                           "rng": np.random.RandomState(0),
                           "pyrng": random.Random(0)}, DATASETS)


def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for key in ("bbox_head", "mask_head"):
        cfg[key]["num_classes"] = 80
    return cfg


@pytest.fixture(scope="module")
def pair80():
    return detector_pair(coco80(TINY_MASK_RCNN))


def test_single_device_test_with_segm_and_mask_tta(coco, pair80):
    from dsl_tpu_torch.apis.test import (
        single_device_test, tta_test, tta_test_masks)

    ds = _val_dataset(coco)
    port = pair80[2]
    test_cfg = dict(rcnn=dict(TINY_MASK_RCNN["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    metrics, results = single_device_test(
        port, None, ds, test_cfg=test_cfg, canvas_hw=HW, img_scale=(96, 64),
        device="cpu", return_results=True)
    assert all(0.0 <= metrics[k] <= 1.0 for k in ("bbox_mAP", "segm_mAP"))
    for info, (dets, labels, rles) in zip(ds.data_infos, results):
        assert len(dets) == len(labels) == len(rles) > 0
        assert all(r["size"] == [info["height"], info["width"]] for r in rles)
    merged = tta_test(port, None, ds, test_cfg=test_cfg,
                      img_scales=((96, 64),), flip=True, canvas_hw=HW,
                      max_per_img=MAX_DETS, evaluate=False, device="cpu")
    out = tta_test_masks(port, None, ds, merged, img_scales=((96, 64),),
                         flip=True, canvas_hw=HW, max_per_img=MAX_DETS,
                         device="cpu")
    for info, (d, lab, rles), (md, _) in zip(ds.data_infos, out, merged):
        assert len(rles) == len(d) == min(len(md), MAX_DETS)
        assert all(r["size"] == [info["height"], info["width"]] for r in rles)
    # one pass, no flip: the merged boxes' masks are the boxes' own masks
    one = tta_test_masks(port, None, ds, [r[:2] for r in results],
                         img_scales=((96, 64),), flip=False, canvas_hw=HW,
                         max_per_img=MAX_DETS, device="cpu")
    assert [r[2] for r in one] == [r[2] for r in results]


def test_test_cli_evaluates_segm(coco, pair80, tmp_path):
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    cfg = Config.fromfile("configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = coco80(TINY_MASK_RCNN)
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_mask.py")
    Config(raw).dump(path)
    ckpt = str(tmp_path / "seeded.pth")
    torch.save(pair80[2].state_dict(), ckpt)
    out = str(tmp_path / "dets.bbox.json")
    results, metrics = test_cli.main([path, ckpt, "--eval", "bbox", "segm",
                                      "--out", out, "--device", "cpu"])
    assert len(results) == 3 and len(results[0]) == 3
    assert {"bbox_mAP", "segm_mAP"} <= set(metrics)
    segm = json.loads(open(out.replace(".bbox.json", ".segm.json")).read())
    assert segm and all("counts" in d["segmentation"] for d in segm)


# -- slow: whole-detector comparisons and an epoch ------------------------------

@pytest.mark.slow
def test_mask_rcnn_predict_matches_jax(pair):
    det, var, port = pair
    x = U.images(3, B, HW)
    shapes = np.asarray([[64, 96], [60, 90]], np.float32)
    sfs = np.asarray([[1.5, 1.5, 1.5, 1.5], [1.0, 1.0, 1.0, 1.0]], np.float32)
    want = j_two.mask_rcnn_predict(det, var, jnp.asarray(x),
                                   img_shapes=jnp.asarray(shapes),
                                   scale_factors=jnp.asarray(sfs))
    got = two_stage.mask_rcnn_predict(port, U.nchw(x), img_shapes=t(shapes),
                                      scale_factors=t(sfs))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    assert float((got[3] - t(want[3])).abs().max()) < 1e-4


def recording_jax_paste(monkeypatch) -> list:
    """Records the JAX package's ``paste_masks`` inputs (probabilities and
    boxes) in call order, one call per image."""
    pasted = []
    real = j_mask.paste_masks

    def paste(probs, boxes, h, w, **kw):
        pasted.append((np.array(probs), np.array(boxes)))
        return real(probs, boxes, h, w, **kw)

    monkeypatch.setattr(j_mask, "paste_masks", paste)
    return pasted


@pytest.mark.slow
def test_single_device_test_with_segm_matches_jax(coco, pair80, monkeypatch):
    """Both packages' ``single_device_test`` with segm on the tiny COCO
    instance set, one set of weights: labels equal, dets within 1e-5
    relative and 1e-4 absolute; each image's pasted masks equal to JAX's
    but at pixels where OpenCV's resize of JAX's probabilities lies within
    ``PASTE_ULPS`` ulps of 0.5 (counted); the bbox and segm metrics
    within 1e-12 where the masks are equal."""
    from dsl_tpu.apis.test import single_device_test as j_test
    from dsl_tpu_torch.apis.test import single_device_test

    det, var, port = pair80
    test_cfg = dict(rcnn=dict(TINY_MASK_RCNN["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    kw = dict(test_cfg=test_cfg, canvas_hw=HW, img_scale=(96, 64),
              return_results=True)
    pasted = recording_jax_paste(monkeypatch)
    want_metrics, want = j_test(det, var, _val_dataset(coco, port=False),
                                **kw)
    got_metrics, got = single_device_test(port, None, _val_dataset(coco),
                                          device="cpu", **kw)
    assert len(got) == len(want) == len(pasted)
    flips = 0
    for (gd, gl, rles), (wd, wl, masks), (probs, boxes) in zip(
            got, want, pasted):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
        assert len(rles) == len(masks) > 0
        flips += paste_flips(np.stack([decode_rle(r) for r in rles]), masks,
                             probs, boxes)
    total = sum(m.size for _, _, m in want)
    print(f"single_device_test masks: {flips} of {total} pixels differ, "
          f"each within {PASTE_ULPS} ulps of 0.5")
    keys = [k for k in want_metrics if k.startswith(("bbox_", "segm_"))]
    assert {"bbox_mAP", "segm_mAP"} <= set(keys)
    for k in keys if flips == 0 else [k for k in keys if k.startswith("bbox_")]:
        assert abs(got_metrics[k] - want_metrics[k]) <= 1e-12, k


@pytest.mark.slow
def test_tta_test_masks_matches_jax(coco, pair80, monkeypatch):
    """``tta_test_masks`` at two scales with flips, both packages on one
    set of weights and the same merged boxes: each image's masks equal to
    JAX's but at pixels where OpenCV's resize of JAX's averaged
    probabilities lies within ``PASTE_ULPS`` ulps of 0.5 (counted)."""
    from dsl_tpu.apis.test import tta_test_masks as j_tta
    from dsl_tpu_torch.apis.test import tta_test_masks

    det, var, port = pair80
    ds, jds = _val_dataset(coco), _val_dataset(coco, port=False)
    rng = np.random.RandomState(9)
    merged = []
    for info in ds.data_infos:
        n = rng.randint(1, 6)
        x1 = rng.uniform(0, info["width"] - 60, n)
        y1 = rng.uniform(0, info["height"] - 60, n)
        d = np.stack([x1, y1, x1 + rng.uniform(8, 60, n),
                      y1 + rng.uniform(8, 60, n), rng.rand(n)], 1)
        merged.append((d.astype(np.float32), rng.randint(0, 80, n)))
    kw = dict(img_scales=((96, 64), (120, 80)), flip=True, canvas_hw=(96, 128))
    got = tta_test_masks(port, None, ds, merged, device="cpu", **kw)
    pasted = recording_jax_paste(monkeypatch)
    want = j_tta(det, var, jds, merged, **kw)
    assert len(pasted) == len(want) == len(got)
    flips = 0
    for (_, _, rles), (_, _, masks), (probs, boxes) in zip(got, want, pasted):
        assert len(rles) == len(masks)
        flips += paste_flips(np.stack([decode_rle(r) for r in rles]), masks,
                             probs, boxes)
    total = sum(m.size for _, _, ms in want for m in ms)
    print(f"tta masks: {flips} of {total} pixels differ, each within "
          f"{PASTE_ULPS} ulps of 0.5")


@pytest.mark.slow
def test_train_detector_on_tiny_coco_logs_loss_mask(coco, tmp_path):
    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.config import Config

    cfg = Config.fromfile(
        "configs/mask_rcnn/mask_rcnn_r50_caffe_fpn_mstrain_1x_coco.py")
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["model"] = dict(coco80(TINY_MASK_RCNN),
                        backbone=dict(TINY_MASK_RCNN["backbone"], style="caffe"))
    raw["canvas_hw"] = list(HW)
    for step in raw["data"]["train"]["pipeline"]:
        if step["type"] == "Resize":
            step["img_scale"] = [(96, 64), (90, 60)]
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
    assert steps and all(np.isfinite(x["loss_mask"]) for x in steps)
    assert val and 0.0 <= val[-1]["segm_mAP"] <= 1.0
