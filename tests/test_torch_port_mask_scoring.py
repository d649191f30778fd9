"""The port's Mask Scoring R-CNN against the JAX package.

Seeded numpy inputs through each JAX function and its port, at 64x96 and
``synthetic_data.TINY_MASK_SCORING_RCNN`` (``TINY_MASK_RCNN`` with a
4-conv, 32-channel ``MaskIoUHead`` and 64-wide FCs; 20 classes), f32:

- ``MaskIoUHead`` through the weight bridge (its ``fc0`` rows permuted):
  1e-5 of the largest magnitude;
- ``gt_area_inside``: 3e-7 relative (compiled, XLA rounds the cell's
  area an ulp otherwise);
  ``mask_iou_target``: 1e-6; ``mask_iou_loss``: 1e-6 relative;
- ``loss_mask`` and ``loss_mask_iou`` (``two_stage.mask_branch_losses``)
  given the same samples, features and targets (JAX's targets handed to
  the port, as in the Mask R-CNN file): 1e-5 relative; the gradient of
  ``loss_mask_iou`` in the mask head's ``conv_logits`` (the probabilities
  are not detached): 1e-4 of its largest magnitude, and not zero;
- predict is Mask R-CNN's: the same dets and probabilities as the Mask
  R-CNN with the same weights (no score rescaled);
- the weight bridge both ways and an mmdet-keyed ``.pth``
  (``roi_head.mask_iou_head.convs.i.conv`` / ``fcs.i`` / ``fc_mask_iou``);
- every config of ``configs/ms_rcnn/`` built on the meta device, with the
  JAX package's parameter counts for two;
- ``single_device_test`` with ``segm`` and the test CLI's ``--eval bbox
  segm`` on a tiny COCO instance set;
- slow: the whole loss with JAX's draws and JAX's mask targets (a
  target pixel tied at 0.5 would flip otherwise) against JAX's (compiled
  JAX, about 15 s): every loss 1e-5 relative.
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
from dsl_tpu.models.detectors import two_stage as j_two
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu.models.roi_heads import maskiou_head as j_miou
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.models.detectors import two_stage
from dsl_tpu_torch.models.roi_heads import maskiou_head
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_MASK_RCNN, TINY_MASK_SCORING_RCNN, coco_instance_config)
from test_torch_port_mask_rcnn import (  # noqa: F401 (a fixture)
    MAX_DETS, TINY_TEST_PIPELINE, _samples, _val_dataset, coco, mask_batch)

torch.set_num_threads(2)

HW = (64, 96)
B = 2
# the JAX package's parameter counts (jax.eval_shape of
# init_detector_variables)
CONFIGS = {"ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py": 60736640,
           "ms_rcnn/ms_rcnn_x101_64x4d_fpn_1x_coco.py": 118634880}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def detector_pair(cfg: dict, seed: int = 0):
    """The JAX detector, its seeded variables (the mask IoU head's too) and
    the port's detector with them, in eval mode."""
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda r, x: init_detector_variables(det, r, x),
                            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    var = {k: U._plain(v) for k, v in fill_variables(dict(shapes), seed).items()}
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(flax_to_state_dict(var))
    return det, var, port.eval()


@pytest.fixture(scope="module")
def pair():
    return detector_pair(TINY_MASK_SCORING_RCNN)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-12))


def test_mask_iou_head_matches_jax(pair):
    det, var, port = pair
    rng = np.random.RandomState(1)
    feats = rng.randn(5, 14, 14, 32).astype(np.float32)
    probs = rng.rand(5, 28, 28).astype(np.float32)
    want = det.apply(var, jnp.asarray(feats), jnp.asarray(probs),
                     method=det.mask_iou_forward)
    got = port(U.nchw(feats), stage="mask_iou", mask_pred=t(probs))
    assert tuple(got.shape) == (5, 20) and rel_err(got, want) < 1e-5


def iou_inputs(seed: int, n: int = 24, m: int = 112):
    """Crops, GT boxes, RoIs (some past the image, some cut by it, one
    thinner than a pixel), image shapes and full areas for ``n`` RoIs."""
    rng = np.random.RandomState(seed)
    shapes = np.tile(np.asarray([[60, 90]], np.float32), (n, 1))
    shapes[::2] = (64, 96)
    gx1, gy1 = rng.uniform(-3, 70, n), rng.uniform(-3, 45, n)
    gt = np.stack([gx1, gy1, gx1 + rng.uniform(2, 40, n),
                   gy1 + rng.uniform(2, 30, n)], 1).astype(np.float32)
    rois = gt + rng.uniform(-8, 8, (n, 4)).astype(np.float32)
    rois[0] = (10.2, 10.7, 10.9, 40.0)
    crops = (rng.rand(n, m, m) < 0.6).astype(np.uint8)
    areas = (crops.reshape(n, -1).mean(1) * (gt[:, 2] - gt[:, 0])
             * (gt[:, 3] - gt[:, 1]) * rng.uniform(1.0, 1.5, n))
    return crops, gt, rois, shapes, areas.astype(np.float32)


@pytest.mark.parametrize("seed", range(2))
def test_gt_area_inside_matches_jax(seed):
    args = iou_inputs(seed)[:4]
    want = jax.jit(j_miou._gt_area_inside)(*(jnp.asarray(a) for a in args))
    got = maskiou_head.gt_area_inside(*(t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-7,
                               atol=0)
    assert float(got.min()) == 0.0 and float(got.max()) > 100


def test_mask_iou_target_and_loss_match_jax():
    crops, gt, rois, shapes, areas = iou_inputs(2)
    rng = np.random.RandomState(3)
    n = len(rois)
    pred = rng.rand(n, 28, 28).astype(np.float32)
    targets = (rng.rand(n, 28, 28) < 0.5).astype(np.float32)
    pos = (rng.rand(n) < 0.8).astype(np.float32)
    want = jax.jit(lambda *a: j_miou.mask_iou_target(
        *a[:3], gt_full_areas=a[3], crops=a[4], gt_boxes=a[5], rois=a[6],
        img_shapes=a[7]))(*(jnp.asarray(a) for a in (
            pred, targets, pos, areas, crops, gt, rois, shapes)))
    got = maskiou_head.mask_iou_target(
        t(pred), t(targets), t(pos), t(areas), t(crops), t(gt), t(rois),
        t(shapes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    iou_pred = rng.rand(n, 20).astype(np.float32)
    labels = rng.randint(0, 21, n)
    want_l = j_miou.mask_iou_loss(jnp.asarray(iou_pred), jnp.asarray(labels),
                                  want, jnp.asarray(pos), 20)
    got_l = maskiou_head.mask_iou_loss(t(iou_pred), t(labels), got, t(pos), 20)
    assert abs(float(got_l) - float(want_l)) <= 1e-6 * float(want_l)


def _levels(pair, seed: int):
    """Random FPN levels of the detector's shapes: JAX's NHWC list and the
    port's NCHW one."""
    with torch.no_grad():
        shapes = [f.shape for f in pair[2](torch.zeros((B, 3, *HW)))[0]]
    rng = np.random.RandomState(seed)
    levels = [rng.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(np.transpose(f, (0, 2, 3, 1))) for f in levels],
            [torch.from_numpy(f) for f in levels])


def iou_batch(seed: int) -> dict:
    """:func:`mask_batch` with each instance's full area: its crop's area
    in image pixels, and more where the instance runs past its box."""
    batch = mask_batch(seed)
    gt = batch["gt_bboxes"]
    box = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    frac = batch["gt_mask_crops"].reshape(*gt.shape[:2], -1).mean(-1)
    grow = np.random.RandomState(seed).uniform(1.0, 1.3, box.shape)
    batch["gt_mask_areas"] = (box * frac * grow).astype(np.float32)
    return batch


def test_mask_branch_losses_match_jax_given_its_samples(pair, monkeypatch):
    det, var, port = pair
    port = copy.deepcopy(port)
    batch = iou_batch(4)
    num_samples = 32
    samples = _samples(batch, 4, num_samples)
    jfeats, pfeats = _levels(pair, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = {k: jnp.asarray(v) for k, v in samples.items()}

    def j_losses(v):
        lm, lmiou, _ = j_two._mask_branch_loss(det, v, jfeats, js, jb,
                                               num_samples=num_samples)
        return lmiou, lm

    (want_miou, want_m), grads = jax.jit(jax.value_and_grad(
        j_losses, has_aux=True))(var)
    want_grad = np.asarray(grads["params"]["mask_head"]["conv_logits"]
                           ["kernel"])[0, 0].T          # (classes, channels)

    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    got = two_stage.mask_branch_losses(
        port, pfeats, {k: t(v) for k, v in samples.items()}, pb, num_samples)
    assert set(got) == {"loss_mask", "loss_mask_iou"}
    for key, want in (("loss_mask", want_m), ("loss_mask_iou", want_miou)):
        assert abs(float(got[key].detach()) - float(want)) <= 1e-5 * abs(
            float(want)), key
    got["loss_mask_iou"].backward()
    grad = port.mask_head.conv_logits.weight.grad[:, :, 0, 0]
    assert float(grad.abs().max()) > 0
    assert rel_err(grad, want_grad) < 1e-4


def test_predict_is_mask_rcnns(pair):
    """No score rescaled: the Mask R-CNN with the same weights (the IoU
    head dropped) gives the same dets, labels and probabilities."""
    port = pair[2]
    plain = build_detector(copy.deepcopy(TINY_MASK_RCNN))
    plain.load_state_dict({k: v for k, v in port.state_dict().items()
                           if "mask_iou_head" not in k})
    x = U.nchw(U.images(6, B, HW))
    shapes = t([[64, 96], [60, 90]])
    got = two_stage.mask_rcnn_predict(port, x, img_shapes=shapes)
    want = two_stage.mask_rcnn_predict(plain.eval(), x, img_shapes=shapes)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[2].sum()) > 0


def test_bridge_and_mmdet_pth_round_trip(pair, tmp_path):
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    _, var, port = pair
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var[col])
    for k in ("fc0", "conv0", "fc_mask_iou"):
        np.testing.assert_array_equal(back["params"]["mask_iou_head"][k]["kernel"],
                                      var["params"]["mask_iou_head"][k]["kernel"])
    again = flax_to_state_dict(back)
    assert sorted(again) == sorted(k for k in sd
                                   if not k.endswith("num_batches_tracked"))
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k
    assert {"roi_head.mask_iou_head.convs.3.conv.weight",
            "roi_head.mask_iou_head.fcs.1.weight",
            "roi_head.mask_iou_head.fc_mask_iou.bias"} <= set(sd)
    # the conv reads (RoI features, pooled mask): 32 + 1 channels
    assert tuple(sd["roi_head.mask_iou_head.convs.0.conv.weight"].shape) == (
        32, 33, 3, 3)
    path = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    fresh = build_detector(copy.deepcopy(TINY_MASK_SCORING_RCNN))
    missing, unexpected = load_torch_detector(str(path), fresh)
    assert not missing and not unexpected
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())


@pytest.mark.parametrize("config", sorted(
    p[len("configs/"):] for p in glob.glob("configs/ms_rcnn/*.py")))
def test_the_ms_rcnn_configs_build(config):
    from dsl_tpu_torch.config import Config

    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ == "MaskScoringRCNN"
    assert det.mask_iou_head is not None and det.mask_head is not None
    if config in CONFIGS:
        assert sum(p.numel() for p in det.parameters()) == CONFIGS[config]


def coco80(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for key in ("bbox_head", "mask_head", "mask_iou_head"):
        cfg[key]["num_classes"] = 80
    return cfg


def test_single_device_test_and_cli_with_segm(coco, tmp_path):
    from dsl_tpu_torch.apis.test import single_device_test
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.tools import test as test_cli

    port = detector_pair(coco80(TINY_MASK_SCORING_RCNN))[2]
    test_cfg = dict(rcnn=dict(TINY_MASK_RCNN["test_cfg"]["rcnn"],
                              max_per_img=MAX_DETS))
    metrics, results = single_device_test(
        port, None, _val_dataset(coco), test_cfg=test_cfg, canvas_hw=HW,
        img_scale=(96, 64), device="cpu", return_results=True)
    assert all(0.0 <= metrics[k] <= 1.0 for k in ("bbox_mAP", "segm_mAP"))
    assert all(len(r) == 3 and len(r[2]) == len(r[0]) > 0 for r in results)
    raw = coco_instance_config(Config.fromfile(
        "configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py").to_dict(), coco)
    raw["model"] = coco80(TINY_MASK_SCORING_RCNN)
    raw["model"]["test_cfg"] = test_cfg
    raw["canvas_hw"] = list(HW)
    for key in ("val", "test"):
        raw["data"][key]["pipeline"] = copy.deepcopy(TINY_TEST_PIPELINE)
    path = str(tmp_path / "tiny_ms.py")
    Config(raw).dump(path)
    ckpt = str(tmp_path / "seeded.pth")
    torch.save(port.state_dict(), ckpt)
    cli_results, cli_metrics = test_cli.main(
        [path, ckpt, "--eval", "bbox", "segm", "--device", "cpu"])
    assert [r[2] for r in cli_results] == [r[2] for r in results]
    assert cli_metrics["segm_mAP"] == metrics["segm_mAP"]


# -- slow: the whole loss --------------------------------------------------------

@pytest.mark.slow
def test_mask_scoring_loss_matches_jax(pair, monkeypatch):
    from test_torch_port_two_stage import jax_draws

    det, var, port = pair
    batch = iou_batch(8)
    batch["images"] = U.images(8, B, HW)
    batch["img_shapes"] = np.asarray([[64, 96], [60, 90]], np.float32)
    want = jax.jit(lambda v, b_: j_two.two_stage_loss(
        det, v, b_, rng_key=jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.asarray(3, jnp.uint32)))[1])(
        var, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(two_stage, "sampler_draws",
                        lambda it, b, a, n, dev: jax_draws(it, b, a, n))
    # JAX's targets on the port's RoIs: a tied target pixel would flip
    # (the port's own targets are held to JAX's in the Mask R-CNN file)
    monkeypatch.setattr(two_stage, "mask_targets_from_crops",
                        U.jax_mask_targets)
    pb = {k: t(v, torch.int64 if k == "gt_labels" else None)
          for k, v in batch.items()}
    pb["images"] = U.nchw(batch["images"])
    _, got = two_stage.two_stage_loss(copy.deepcopy(port).train(), pb,
                                      cur_iter=3)
    assert set(got) == set(want) >= {"loss_mask", "loss_mask_iou"}
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), k
