"""The NMS kernel and the train path on the card (marker ``cuda``; skipped
where there is none).

Runs without JAX, so it can run on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

- ``nms_keep`` launches ``csrc/nms_kernel.cu`` and gives keeps bit-identical
  to ``nms_keep_reference`` on every case of ``dsl_tpu_torch.ops.nms_cases``,
  the card-only ``timing_cases()`` included;
- the wrapper refuses what the kernel does not take (a non-contiguous or
  misaligned box tensor, tensors on two devices) instead of launching, and
  takes an N past the first kernel's shared-memory ceiling (about 28k);
- the launch goes to the tensors' card whichever card is current (two
  cards needed);
- one f32 train step of the tiny flagship on the card agrees with the same
  step on the CPU (losses within 1e-4 and ``grad_norm`` within 1e-3
  relative, the updated parameters within 5% of each one's update, floor
  1e-5), and the teacher's eval step launches the NMS kernel once;
- nvJPEG decodes each JPEG fixture within the stated tolerance of its
  committed OpenCV decode (``DECODE_*`` below: libjpeg-turbo's chroma
  upsampling and IDCT part from nvJPEG's by a few levels at colour edges),
  and a file that is neither JPEG nor PNG raises on the CUDA route, naming
  its format (a damaged PNG raises ``PngError``);
  decodes enqueued on a stream that is still busy (as the loader's and the
  refresh's are, behind a train step) equal decodes on an idle one;
- ``inference_detector`` takes a path on the card (nvJPEG, no OpenCV) and
  preprocesses it as it does the committed decode, within that tolerance;
- a pseudo-label refresh on the refresher's side stream gives the NMS keeps
  and detections of the same refresh on the main stream;
- every image op of the strong augmentations, and ``PatchShuffle``,
  ``RandomAugmentBBox`` (every ``aug_type``), ``RandomAugmentBBox_Fast``
  and ``UBAug`` from the same seeds, give on the card images bit-identical
  to the CPU's (which the CPU tests hold against Pillow, OpenCV and the
  JAX package) and equal boxes, without a host sync;
- ``resize_linear_u8`` on the card is bit-identical to the CPU (which the
  CPU tests hold to ``cv2.resize``) on the fixtures at the train scales;
- ``read_image`` on the card applies a fixture's EXIF orientation (1-8,
  both byte orders) as OpenCV does: the committed decode turned by numpy,
  within the decode tolerance; the probe ``readable`` refuses what
  ``cv2.imread`` cannot read (a header cut short, empty, SOI and garbage,
  missing) and passes the fixtures and a PNG (which then decodes; the
  same PNG without its IEND chunk does not pass); a JPEG
  cut inside its entropy-coded body (a fixture, and one with restart
  markers, which nvJPEG takes only completed) passes the probe and
  decodes to OpenCV's gray fill from OpenCV's first gray row, its rows
  above the band the data ends in as nvJPEG decodes the whole file; the
  committed cuts of the progressive fixture go to nvJPEG as the committed
  baseline transcode (sha256), nothing filled, and decode within the
  decode tolerance of OpenCV's decode of the cut file (its committed 4x4
  means);
- the test-time flip (mirror, then resize) on the card is bit-identical
  to the CPU's on the same decode; the header size reader gives the
  fixtures' sizes and an EXIF-rotated copy's stored and turned sizes
  without PIL or OpenCV;
- each committed PNG fixture decodes on the card route (the host C
  unfilter, one upload, the colour rules on the card) to the CPU route's
  tensor (which the CPU tests hold to ``cv2.imread``), and the C unfilter
  gives the numpy plain version's bytes; ``Rotate`` and
  ``PhotoMetricDistortion`` from the same seeds give on the card the CPU's
  images and boxes, without a host sync;
- ``resize_linear_f32`` (SSD's float resize) on the card is bit-identical
  to the CPU (which the CPU tests hold to ``cv2.resize``) on the fixtures
  as float at SSD's sizes and an upscale; the tiny SSD's predict on the
  card launches the NMS kernel once, and its head outputs and dets agree
  with the CPU's (within 1e-4 of the largest magnitude; valid equal, the
  dets with their labels compared as sets per image);
- the mask path's ops on the card (polygon rasterisation, the nearest
  resize, a GT crop, the paste) are bit-identical to the CPU's, the mask
  targets equal but at ties at 0.5; the tiny Mask R-CNN's mask logits on
  the card agree with the CPU's (1e-4 of the largest magnitude) and its
  predict launches the NMS kernel twice;
- the tiny Cascade Mask R-CNN's stage heads, mask head and predict on the
  card agree with the CPU's (heads 1e-4 of the largest magnitude; the
  dets as sets per image) with two NMS launches; the tiny Cascade Mask
  R-CNN's and Mask Scoring R-CNN's losses on the card, the samplers'
  draws made on the host, agree with the CPU's within 1e-4 relative (a
  stage's sample may move only where a box crosses its IoU threshold by
  the devices' rounding: 1e-3 for the later stages) with one launch;
- the tiny HTC's and SCNet's heads (the semantic head on seeded levels,
  the mask heads with the information flow, the global-context, relay and
  box heads) and predicts on the card agree with the CPU's (heads 1e-4 of
  the largest magnitude; the dets as sets per image, the masks'
  probabilities of the paired dets 1e-4) with two NMS launches, and their
  losses, the samplers' draws made on the host, within 1e-4 relative
  (1e-3 for the later stages and the mask losses, whose samples and
  targets move with the RoIs' rounding) with one launch;
- ``htc.resize_bilinear`` (JAX's resize as two matrix products) and a
  SAC block (its average pool and spatial means) on the card agree with
  the CPU within 1e-5, and their backward repeats bit for bit;
- the tiny PointRend's, YOLACT's and Seesaw Mask R-CNN's heads (the coarse
  and point heads and a subdivision; the head, protonet and segm head; the
  normed mask head and the split activation) and predicts on the card
  agree with the CPU's (heads 1e-4 of the largest magnitude; the dets as
  sets per image), with 2, 0 and 2 NMS launches; ``fast_nms`` on the card
  equals the CPU's; their losses, the samplers' and points' draws made on
  the host, within 1e-4 relative (1e-3 for the mask and point losses,
  whose samples and targets move with the RoIs' rounding), with 1, 0 and
  1 launches;
- slice 16's backbones (the tiny HRNet under Faster R-CNN and FCOS,
  RegNetX-400MF, ResNeSt-50, Res2Net-50, MobileNetV2 at a quarter width),
  their levels and their necks' on the card agree with the CPU's (1e-4 of
  the largest magnitude); HRNet's nearest resize (an odd size), an
  ``HRModule``'s fuse and ``HRFPN`` (average and max pooling) on the card
  agree with the CPU within 1e-5 and their backward repeats bit for bit;
- deformable convolution (v1 at dilation 2, DCNv2 at stride 2 with 4
  offset groups and a grouped kernel) and deformable RoI pooling on the
  card agree with the CPU within 1e-5, forward and every gradient (the
  input's, the offsets', the mask's, the kernel's), at offsets that move
  samples off the map; two backward passes on the card give the same
  bits;
- the plugins' and necks' ops: ``carafe`` (5x5 taps at scale 2 on an odd source),
  ``GeneralizedAttention`` (``'1111'``, ``kv_stride`` 2, ``spatial_range``
  3, on an odd map) and NAS-FPN's resize (its repeat and its pool) on the
  card agree with the CPU within 1e-5, forward and every gradient (the
  input's, the kernels', every parameter's), and two backward passes on
  the card give the same bits;
- ``chip_smoke.py``'s walk of a trace's raw records gives the kernels' time
  and each ``record_function`` range's, forward and backward, of torch's
  own event tree within 1e-3;
- ``train_detector`` and ``single_device_test`` refuse to start without
  CUDA (these run everywhere).
"""

import json

import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.ops import nms_cases
from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
from dsl_tpu_torch.train import (
    build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
    make_eval_step, make_train_step)
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_batch import to_torch
from torch_port_make_fixtures import (
    FIXTURES, OUT, PNG_FIXTURES, PROGRESSIVE, RESTART, load_decodes)

CASES = nms_cases.cases() + [nms_cases.tiny_boxes()] + nms_cases.timing_cases()
# nvJPEG vs OpenCV, per fixture: mean |diff| in levels, share of values off
# by more than 4, largest difference
DECODE_MEAN, DECODE_SHARE_OVER_4, DECODE_MAX = 1.5, 0.03, 48


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(card, case):
    _, boxes, valid, thr = case
    b = torch.from_numpy(boxes).to(card)
    v = torch.from_numpy(valid).to(card)
    before = nms_keep.launches
    got = nms_keep(b, v, thr)
    want = nms_keep_reference(b, v, thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    _, boxes, valid, thr = nms_cases.cases(max_n=65)[1]
    b = torch.from_numpy(boxes).to(card)
    v = torch.from_numpy(valid).to(card)
    before = nms_keep.launches
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(b.transpose(0, 1).contiguous().transpose(0, 1), v, thr)
    shifted = torch.empty(b.numel() + 1, device=card)[1:].view_as(b)
    shifted.copy_(b)
    with pytest.raises(ValueError, match="aligned"):
        nms_keep(shifted, v, thr)
    with pytest.raises(ValueError, match="one CUDA device"):
        nms_keep(b, v.cpu(), thr)
    assert nms_keep.launches == before
    # the first version's scan kept (N/64 + 1) * N/8 bytes in shared memory
    # and refused N of about 28k and more; the scratch in device memory is
    # the only limit now
    big = torch.from_numpy(nms_cases.random_boxes(np.random.RandomState(0), 1,
                                                  40000)).to(card)
    keep = nms_keep(big, torch.ones(1, 40000, dtype=torch.bool, device=card), thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1 and bool(keep[0, 0])


@pytest.mark.cuda
def test_kernel_runs_on_the_tensors_card_not_the_current_one(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the tensors on one, the other current")
    _, boxes, valid, thr = nms_cases.cases(max_n=65)[1]
    other = torch.device("cuda", 1)
    b = torch.from_numpy(boxes).to(other)
    v = torch.from_numpy(valid).to(other)
    with torch.cuda.device(0):
        got = nms_keep(b, v, thr)
    torch.cuda.synchronize(other)
    assert got.device == other
    assert torch.equal(got, nms_keep_reference(b, v, thr))


def _tiny_train(device):
    """The tiny flagship's train entry point on ``device``, seeded weights."""
    det = build_detector(U.TINY_CFG)
    variables = U.fill_variables(state_dict_to_flax(det.state_dict()), seed=0)
    det.load_state_dict(flax_to_state_dict(variables))
    frozen = frozen_backbone_mask(det, 1)
    tx, _ = build_optimizer_from_cfg(
        U.OPTIMIZER, U.OPTIMIZER_CONFIG, U.LR_CONFIG,
        steps_per_epoch=U.STEPS_PER_EPOCH)
    state = create_train_state(det, tx, device=device)
    step = make_train_step(det, tx, ema_start_iter=1, frozen_mask=frozen,
                           device=device)
    return state, step


@pytest.mark.cuda
def test_train_step_matches_cpu(card):
    out = {}
    for device in (card, torch.device("cpu")):
        state, step = _tiny_train(device)
        init = {n: p.detach().cpu().clone()
                for n, p in state.student.named_parameters()}
        metrics = step(state, to_torch(U.semi_batch(), device))
        out[device.type] = ({k: float(v) for k, v in metrics.items()},
                            {n: p.detach().cpu()
                             for n, p in state.student.named_parameters()})
    (m_card, p_card), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    assert set(m_card) == set(m_cpu)
    for k, v in m_cpu.items():
        np.testing.assert_allclose(m_card[k], v, err_msg=k,
                                   rtol=1e-3 if k == "grad_norm" else 1e-4)
    moved = 0
    for n, want in p_cpu.items():
        dw, dg = want - init[n], p_card[n] - init[n]
        scale = float(torch.maximum(dw.abs().max(), dg.abs().max()))
        assert float((dg - dw).abs().max()) <= max(0.05 * scale, 1e-5), n
        moved += scale > 0
    assert moved > 50


@pytest.mark.cuda
def test_teacher_eval_step_launches_nms_once(card):
    state, step = _tiny_train(card)
    batch = to_torch(U.semi_batch(), card)
    before = nms_keep.launches
    step(state, batch)
    torch.cuda.synchronize()
    assert nms_keep.launches == before
    dets, _, valid = make_eval_step(state.student, use_teacher=True,
                                    device=card)(state, batch["images"])
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert dets.shape == (4, 100, 5) and bool(torch.isfinite(dets).all())


def _decode_within_tolerance(got: torch.Tensor, want: torch.Tensor):
    d = (got.int() - want.int()).abs()
    assert float(d.float().mean()) <= DECODE_MEAN
    assert float((d > 4).float().mean()) <= DECODE_SHARE_OVER_4
    assert int(d.max()) <= DECODE_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_nvjpeg_matches_cv2_decode(card, name):
    from dsl_tpu_torch.data.image_io import read_image

    h, w, _ = FIXTURES[name]
    got = read_image(OUT / f"{name}.jpg", card)
    torch.cuda.synchronize()
    assert got.shape == (h, w, 3) and got.dtype == torch.uint8
    assert got.device.type == "cuda"
    _decode_within_tolerance(got.cpu(), torch.from_numpy(load_decodes()[name]))


@pytest.mark.cuda
def test_decodes_queued_behind_work_equal_decodes_on_an_idle_stream(card):
    """Twenty decodes (past the decoder's ring of eight staging states)
    enqueued behind 0.1 s of work on their stream."""
    from dsl_tpu_torch.data.image_io import read_image

    paths = [OUT / f"{n}.jpg" for n in sorted(FIXTURES)]
    want = [read_image(p, card) for p in paths]
    torch.cuda.synchronize()
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        got = [read_image(p, card) for p in paths * 5]
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % len(paths)]), i


@pytest.mark.cuda
def test_non_jpeg_raises_on_the_cuda_route(card, tmp_path):
    from dsl_tpu_torch.data.image_io import read_image

    from dsl_tpu_torch.data.png import PngError

    png = tmp_path / "x.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    with pytest.raises(PngError):
        read_image(png, card)
    bmp = tmp_path / "x.bmp"
    bmp.write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="BMP is not JPEG"):
        read_image(bmp, card)


@pytest.mark.cuda
def test_inference_detector_reads_a_path_on_the_card(card):
    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.apis.inference import IMG_STD, preprocess
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.data.image_io import read_image

    name = "coco_640x480"
    variables = U.fill_variables(state_dict_to_flax(
        build_detector(U.TINY_CFG).state_dict()), seed=0)
    bundle = init_detector(Config(dict(model=U.TINY_CFG)), variables=variables,
                           device=card, canvas_hw=(96, 128))
    path = OUT / f"{name}.jpg"
    result = inference_detector(bundle, str(path))
    assert len(result) == 80
    assert all(r.shape[1] == 5 and np.isfinite(r).all() for r in result)
    assert sum(len(r) for r in result) > 0
    got, shapes, _ = preprocess(bundle, read_image(path, card))
    want, shapes_want, _ = preprocess(bundle, load_decodes()[name])
    assert torch.equal(shapes, shapes_want)
    # normalized levels back to 0-255 levels, then the decode tolerance
    # (resizing averages neighbours, so it cannot widen the differences)
    std = torch.tensor(IMG_STD, device=card)[None, :, None, None]
    d = ((got - want) * std).abs()
    assert float(d.mean()) <= DECODE_MEAN and float(d.max()) <= DECODE_MAX + 1


@pytest.mark.cuda
def test_refresh_on_the_side_stream_matches_the_main_stream(card, tmp_path):
    import dsl_tpu_torch.core.nms as core_nms
    from dsl_tpu_torch.train.label_store import LabelStore
    from dsl_tpu_torch.train.semi import PseudoLabelRefresher

    state, _ = _tiny_train(card)
    store = LabelStore(str(tmp_path / "store"), {"0": "a"}, {"a": 0})
    names = sorted(f"{n}.jpg" for n in FIXTURES)
    infos = [dict(filename=f"{n}.jpg", height=h, width=w)
             for n, (h, w, _) in sorted(FIXTURES.items())]
    refresher = PseudoLabelRefresher(
        state.student, store, str(OUT), infos, test_cfg=U.TINY_CFG["test_cfg"],
        canvas_hw=(64, 96), img_scale=(96, 64), refresh_batch=8, device=card)
    real, keeps = core_nms.nms_keep, []

    def record(boxes, valid, thr):
        keep = real(boxes, valid, thr)
        keeps.append((torch.cuda.current_stream(card), keep.clone()))
        return keep

    core_nms.nms_keep = record
    try:
        on_main = refresher._predict_all(state.teacher_params, names)
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(side):
            on_side = refresher._predict_all(state.teacher_params, names)
        torch.cuda.synchronize()
    finally:
        core_nms.nms_keep = real
    assert len(keeps) == 2
    assert keeps[0][0] == torch.cuda.default_stream(card)
    assert keeps[1][0] == side
    assert torch.equal(keeps[0][1], keeps[1][1])
    for (_, main_results), (_, side_results) in zip(on_main, on_side):
        for a, b in zip(main_results, side_results):
            for x, y in zip(a[1:], b[1:]):
                assert torch.equal(x, y)


def test_train_detector_raises_without_cuda(monkeypatch, tmp_path):
    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_detector(Config(dict(model=U.TINY_CFG)), str(tmp_path))


def test_single_device_test_raises_without_cuda(monkeypatch):
    from dsl_tpu_torch.apis import single_device_test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        single_device_test(build_detector(dict(U.TINY_CFG)), None, [])


def _op_cases():
    from dsl_tpu_torch.data.pipelines import image_ops as ops
    from dsl_tpu_torch.data.pipelines import strong_aug as sa

    cases = {"blend": lambda x: ops.blend(x.flip(0), x, 1.37),
             "autocontrast": ops.autocontrast, "equalize": ops.equalize,
             "solarize": lambda x: ops.solarize(x, 128),
             "posterize": lambda x: ops.posterize(x, 3),
             "hsv": ops.rgb_to_hsv, "hsv_to_rgb": ops.hsv_to_rgb,
             "hue": lambda x: ops.shift_hue(x, -20),
             "gray_cv": ops.rgb_to_gray_cv, "L": ops.to_l}
    for name in ("color", "contrast", "brightness", "sharpness"):
        cases[name] = (lambda f: lambda x: f(x, 0.46))(getattr(ops, name))
    for sigma in (0.3, 1.7):
        cases[f"blur_{sigma}"] = (lambda s: lambda x: ops.gaussian_blur(x, s))(sigma)
    for kind, strength in (("tx", 0.07), ("ty", -0.09), ("rotate", 23.0),
                           ("shear", -17.0)):
        cases[f"warp_{kind}"] = (lambda k, st: lambda x: ops.warp_affine(
            x, sa._affine_matrix(k, *x.shape[:2], st)))(kind, strength)
    return cases


OP_CASES = sorted(_op_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("name", OP_CASES)
def test_image_op_on_the_card_matches_the_cpu(card, name):
    op = _op_cases()[name]
    img = torch.from_numpy(load_decodes()["coco_640x427"][:301, :413].copy())
    on_card = img.to(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = op(on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), op(img))


STRONG = [dict(type="PatchShuffle", ratio=0.5, ranges=[0.0, 1.0],
               mode=["flip", "flop"]), dict(type="UBAug")] + [
    dict(type=t, aug_type=a) for t in ("RandomAugmentBBox",
                                       "RandomAugmentBBox_Fast")
    for a in ("strong", "strong++", "color", "affine", "cutout", "color_only",
              "except_affine")]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", STRONG, ids=[
    "-".join(str(v) for v in c.values() if v not in (0.5,)) [:40] for c in STRONG])
def test_strong_transform_on_the_card_matches_the_cpu(card, cfg):
    import random

    from dsl_tpu_torch.registry import PIPELINES, build_from_cfg

    t = build_from_cfg(dict(cfg), PIPELINES)
    decodes = load_decodes()
    for seed in range(8):
        img = decodes[sorted(FIXTURES)[seed % len(FIXTURES)]]
        rng = np.random.RandomState(seed)
        x1, y1 = rng.uniform(0, 400, 5), rng.uniform(0, 300, 5)
        boxes = np.stack([x1, y1, x1 + rng.uniform(8, 200, 5),
                          y1 + rng.uniform(8, 150, 5)], 1).astype(np.float32)
        out = []
        for device in (card, "cpu"):
            results = dict(img=torch.from_numpy(img.copy()).to(device),
                           gt_bboxes=boxes[:3].copy(),
                           gt_bboxes_ignore=boxes[3:].copy(),
                           gt_labels=np.arange(3), img_fields=["img"],
                           bbox_fields=["gt_bboxes", "gt_bboxes_ignore"])
            torch.cuda.set_sync_debug_mode("error" if device == card else 0)
            try:
                out.append(t(results, np.random.RandomState(seed),
                             random.Random(seed)))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(out[0]["img"].cpu(), out[1]["img"])
        for key in ("gt_bboxes", "gt_bboxes_ignore", "gt_labels"):
            np.testing.assert_array_equal(out[0][key], out[1][key])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_resize_linear_u8_on_the_card_equals_the_cpu(card, name):
    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
    from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size

    h, w, _ = FIXTURES[name]
    host = torch.from_numpy(load_decodes()[name])
    for scale in ((1333, 640), (1333, 800), (96, 64)):
        nh, nw = keep_ratio_size(h, w, scale)
        got = resize_linear_u8(host.to(card), nh, nw)
        assert torch.equal(got.cpu(), resize_linear_u8(host, nh, nw)), scale


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_on_the_card_route(card, orientation, order,
                                            tmp_path):
    from dsl_tpu_torch.data.image_io import read_image

    name = "coco_500x375"
    path = tmp_path / "tagged.jpg"
    path.write_bytes(U.with_exif((OUT / f"{name}.jpg").read_bytes(),
                                 U.exif_segment(orientation, order)))
    got = read_image(path, card)
    want = U.orient_like_cv2(load_decodes()[name], orientation)
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    _decode_within_tolerance(got.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
@pytest.mark.parametrize("first_read", [4096, 64])
def test_probe_on_the_card_route(card, first_read, tmp_path, monkeypatch):
    from dsl_tpu_torch.data import image_io
    from dsl_tpu_torch.data.image_io import read_image, readable

    # nvjpegGetImageInfo reads the header's prefix, first read as it is or
    # cut to 64 bytes (the header read in doublings)
    monkeypatch.setattr(image_io, "PROBE_FIRST_READ", first_read)
    bad = U.unreadable_files(tmp_path, (OUT / "coco_640x480.jpg").read_bytes())
    for name, path in bad.items():
        assert not readable(path, card), name
    for name in FIXTURES:
        assert readable(OUT / f"{name}.jpg", card), name
    png = tmp_path / "x.png"
    png.write_bytes(U.png_bytes(8, 8))
    assert readable(png, card)
    assert torch.equal(read_image(png, card).cpu(), torch.zeros(8, 8, 3,
                                                               dtype=torch.uint8))
    png.write_bytes(U.png_bytes(8, 8)[:-12])
    assert not readable(png, card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES) + [RESTART])
def test_a_jpeg_cut_in_its_body_decodes_on_the_card(card, name, tmp_path):
    """At each committed cut: the probe passes the file, nvJPEG decodes it
    (a file with restart markers through the completed stream, which it
    takes where it refuses the cut one), the rows from OpenCV's first gray
    row (committed, and the host scan's) are 128 exactly, and the rows
    above the band the data ends in are nvJPEG's decode of the whole file,
    and within the decode tolerance of OpenCV's."""
    from dsl_tpu_torch.data import jpeg_scan
    from dsl_tpu_torch.data.image_io import decode_jpeg, read_image, readable

    data = (OUT / f"{name}.jpg").read_bytes()
    whole = decode_jpeg(data, card).cpu()
    h, w = whole.shape[:2]
    band = 8 if name == "gray_640x480" else 16
    path = tmp_path / "cut.jpg"
    for cut, gray in json.loads((OUT / "cut_fill_rows.json").read_text())[name]:
        path.write_bytes(data[:cut])
        assert readable(path, card)
        got = read_image(path, card).cpu()
        assert tuple(got.shape) == (h, w, 3)
        assert jpeg_scan.cut_fill_row(data[:cut]) == gray
        assert (got[gray:] == 128).all(), cut
        rows = max(0, jpeg_scan.truncated_imcu_row(data[:cut]) * band
                   - (band == 16))
        assert torch.equal(got[:rows], whole[:rows]), cut
        if name in FIXTURES:
            _decode_within_tolerance(got[:rows], torch.from_numpy(
                load_decodes()[name][:rows]))


@pytest.mark.cuda
def test_a_progressive_cut_decodes_on_the_card(card, tmp_path):
    """The progressive fixture cut in its DC scan and in a later scan: the
    card route hands nvJPEG the committed baseline transcode (which the CPU
    tests hold to OpenCV's decode of the cut file, bit for bit), fills
    nothing, and its decode's 4x4 means are within the decode tolerance of
    OpenCV's (committed)."""
    import hashlib

    from dsl_tpu_torch.data import jpeg_scan
    from dsl_tpu_torch.data.image_io import read_image, readable
    from torch_port_make_fixtures import block_sums

    data = (OUT / f"{PROGRESSIVE}.jpg").read_bytes()
    path = tmp_path / "cut.jpg"
    with np.load(OUT / "progressive_cut_means.npz") as sums:
        for cut, sha in json.loads((OUT / "progressive_cuts.json").read_text()):
            stream, fill = jpeg_scan.for_decoder(data[:cut])
            assert fill is None
            assert hashlib.sha256(stream).hexdigest() == sha
            path.write_bytes(data[:cut])
            assert readable(path, card)
            got = block_sums(read_image(path, card).cpu().numpy())
            d = np.abs(got.astype(np.int64) - sums[f"cut_{cut}"]) / 16.0
            assert d.mean() <= DECODE_MEAN and d.max() <= DECODE_MAX, cut
            assert (d > 4).mean() <= DECODE_SHARE_OVER_4, cut


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_flip_then_resize_on_the_card_equals_the_cpu(card, name, tmp_path):
    """The test-time flip (mirror the decode, then resize) on the card is
    bit-identical to the CPU's on the same decode, at the test scale and the
    train scales; ``read_resized(flip=True)`` on the card is that."""
    from dsl_tpu_torch.data.image_io import read_image
    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
    from dsl_tpu_torch.data.pipelines.transforms import (keep_ratio_size,
                                                         read_resized)

    path = OUT / f"{name}.jpg"
    decoded = read_image(path, card)
    for scale in ((1333, 800), (1333, 640), (96, 64)):
        nh, nw = keep_ratio_size(*decoded.shape[:2], scale)
        got = resize_linear_u8(decoded.flip(1), nh, nw)
        assert torch.equal(got.cpu(), resize_linear_u8(decoded.cpu().flip(1),
                                                       nh, nw)), scale
        img, shape, sf = read_resized(path, scale, card, flip=True)
        assert torch.equal(img, got) and shape == [nh, nw]


@pytest.mark.cuda
def test_image_size_on_the_card_route(card, tmp_path):
    """The header size reader needs neither PIL nor OpenCV: the fixtures'
    sizes, and an EXIF orientation 6 copy's stored size and turned size,
    the second the shape ``read_image`` gives on the card."""
    from dsl_tpu_torch.data.image_io import image_size, read_image

    for name, (h, w, _) in FIXTURES.items():
        assert image_size(OUT / f"{name}.jpg", oriented=False) == (w, h)
    path = tmp_path / "rotated.jpg"
    path.write_bytes(U.with_exif((OUT / "coco_640x427.jpg").read_bytes(),
                                 U.exif_segment(6)))
    assert image_size(path, oriented=False) == (640, 427)
    assert image_size(path, oriented=True) == (427, 640)
    assert tuple(read_image(path, card).shape[:2]) == (640, 427)
    assert image_size(tmp_path / "missing.jpg", oriented=True) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PNG_FIXTURES)
def test_png_decodes_on_the_card_as_on_the_cpu(card, name):
    from dsl_tpu_torch.data import png
    from dsl_tpu_torch.data.image_io import read_image, readable

    path = OUT / f"{name}.png"
    image = png.parse(path.read_bytes())
    np.testing.assert_array_equal(png.unfilter_host(image),
                                  png.unfilter_reference(image))
    assert readable(path, card)
    got = read_image(path, card)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), read_image(path, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    dict(type="Rotate", level=7, prob=1.0, img_fill_val=(3, 90, 200)),
    dict(type="PhotoMetricDistortion")], ids=["Rotate", "PhotoMetric"])
def test_new_transform_on_the_card_matches_the_cpu(card, cfg):
    from dsl_tpu_torch.registry import PIPELINES, build_from_cfg

    img = torch.from_numpy(load_decodes()["coco_640x427"])
    boxes = np.asarray([[10, 20, 200, 300], [300, 100, 600, 400]], np.float32)
    t = build_from_cfg(dict(cfg), PIPELINES)
    for seed in range(4):
        out = {}
        for dev in (card, "cpu"):
            r = dict(img=img.to(dev), img_shape=tuple(img.shape),
                     gt_bboxes=boxes.copy(), gt_labels=np.arange(2),
                     bbox_fields=["gt_bboxes"])
            torch.cuda.set_sync_debug_mode("error" if dev == card else 0)
            try:
                out[dev] = t(r, np.random.RandomState(seed))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(out[card]["img"].cpu(), out["cpu"]["img"])
        np.testing.assert_array_equal(out[card]["gt_bboxes"],
                                      out["cpu"]["gt_bboxes"])


def _rpn_nms_input(seed: int, b: int = 8, n: int = 4819):
    """Boxes as the RPN hands them to the kernel at 800x1344: five levels'
    candidates (1000 each, 819 from P6), each level shifted apart by
    ``level * (max + 1)``, sorted by descending score."""
    rng = np.random.RandomState(seed)
    per = [1000, 1000, 1000, 1000, n - 4000]
    xy = rng.uniform(0, 1300, (b, n, 2))
    wh = np.concatenate([rng.uniform(8, 32 * 2 ** i, (b, k, 2))
                         for i, k in enumerate(per)], 1)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    lvl = np.concatenate([np.full(k, i, np.float32) for i, k in enumerate(per)])
    boxes += (lvl * (boxes.max() + 1))[None, :, None]
    order = np.argsort(-rng.rand(b, n), axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1),
            rng.rand(b, n) > 0.02)


@pytest.mark.cuda
def test_nms_kernel_at_the_rpn_size(card):
    boxes, valid = _rpn_nms_input(0)
    b, v = torch.from_numpy(boxes).to(card), torch.from_numpy(valid).to(card)
    got = nms_keep(b, v, 0.7)
    want = nms_keep_reference(b, v, 0.7)
    assert tuple(got.shape) == (8, 4819)
    assert torch.equal(got, want), int((got != want).sum())


def _roi_case(seed: int, n: int = 256):
    from dsl_tpu_torch.ops.roi_align import roi_align

    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(2, 16, 50, 84).astype(np.float32))
    xy = rng.uniform(-20, 330, (n, 2))
    wh = np.exp(rng.uniform(0, 5.5, (n, 2)))
    rois = np.concatenate([rng.randint(0, 2, (n, 1)), xy, xy + wh], 1)
    valid = torch.from_numpy(rng.rand(n) > 0.1)
    cot = torch.from_numpy(rng.randn(n, 16, 7, 7).astype(np.float32))
    return roi_align, feats, torch.from_numpy(rois.astype(np.float32)), valid, cot


@pytest.mark.cuda
def test_roi_align_on_the_card_matches_the_cpu_and_repeats(card):
    roi_align, feats, rois, valid, cot = _roi_case(1)
    out = {}
    for dev, tag in ((card, "a"), (card, "b"), ("cpu", "cpu")):
        f = feats.to(dev).requires_grad_(True)
        y = roi_align(f, rois.to(dev), (7, 7), 0.25, 2, True, valid.to(dev))
        (y * cot.to(dev)).sum().backward()
        out[tag] = (y.detach().cpu(), f.grad.cpu())
    # two backward passes on the card: the same bits (the sorted index_put_)
    assert torch.equal(out["a"][0], out["b"][0])
    assert torch.equal(out["a"][1], out["b"][1])
    for got, want in zip(out["a"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_resize_linear_f32_on_the_card_equals_the_cpu(card, name):
    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_f32

    h, w, _ = FIXTURES[name]
    host = torch.from_numpy(load_decodes()[name].astype(np.float32))
    for nh, nw in ((300, 300), (512, 512), (h * 2, w * 3 // 2)):
        got = resize_linear_f32(host.to(card), nh, nw)
        assert torch.equal(got.cpu(), resize_linear_f32(host, nh, nw)), (nh, nw)


@pytest.mark.cuda
def test_tiny_ssd_predict_on_the_card_matches_the_cpu(card):
    import copy

    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.utils.synthetic_data import TINY_SSD

    det = build_detector(copy.deepcopy(TINY_SSD))
    shapes = state_dict_to_flax(det.state_dict())
    from dsl_tpu_torch.utils.random_weights import fill_variables

    det.load_state_dict(flax_to_state_dict(fill_variables(shapes)))
    det.eval()
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 3, 128, 128).astype(np.float32))
    outs, launches = {}, {}
    for dev in (card, "cpu"):
        d = copy.deepcopy(det).to(dev)
        with torch.no_grad():
            heads = d(x.to(dev))
        before = nms_keep.launches
        dets = detector_predict(d, x.to(dev), device=dev)
        launches[str(dev)] = nms_keep.launches - before
        outs[str(dev)] = [t.cpu() for t in (*heads[0], *heads[1], *dets)]
    assert launches["cuda"] == 1 and launches["cpu"] == 0
    got, want = outs["cuda"], outs["cpu"]
    for g, w in zip(got[:-3], want[:-3]):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    # the detections as sets per image (candidates whose scores differ by
    # the two devices' rounding may swap in NMS order)
    assert torch.equal(got[-1], want[-1]) and int(got[-1].sum()) > 100
    for i in range(x.shape[0]):
        rows = []
        for d, lab, v in (got[-3:], want[-3:]):
            d, lab = d[i][v[i]].numpy(), lab[i][v[i]].numpy()
            order = np.lexsort((np.round(d[:, 1], 1), np.round(d[:, 0], 1), lab))
            rows.append((d[order], lab[order]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_mask_ops_on_the_card_equal_the_cpu(card):
    """The mask path's host-exact ops on the card: polygon rasterisation,
    the nearest resize, a GT crop, the targets' RoIAlign and the paste give
    the CPU's values (which the CPU tests hold to the JAX package and
    OpenCV)."""
    from dsl_tpu_torch.core.masks import rasterize_polygons
    from dsl_tpu_torch.data.pipelines.image_ops import resize_nearest
    from dsl_tpu_torch.models.roi_heads.mask_head import (
        gt_mask_crop, mask_targets_from_crops, paste_masks)

    rng = np.random.RandomState(0)
    polys = [rng.uniform(-5, 600, 24).tolist(), rng.uniform(0, 400, 10).tolist()]
    host = rasterize_polygons(polys, 427, 640)
    assert torch.equal(rasterize_polygons(polys, 427, 640, card).cpu(), host)
    assert torch.equal(resize_nearest(host.to(card), 800, 1199).cpu(),
                       resize_nearest(host, 800, 1199))
    box = np.asarray([30.5, 17.2, 51.9, 30.1], np.float32)
    assert torch.equal(gt_mask_crop(host.to(card), box).cpu(),
                       gt_mask_crop(host, box))
    crops = torch.from_numpy((rng.rand(2, 3, 112, 112) < 0.5).astype(np.uint8))
    gtb = torch.from_numpy(rng.uniform(0, 60, (2, 3, 4)).astype(np.float32))
    gtb[..., 2:] += gtb[..., :2] + 5
    rois = torch.from_numpy(rng.uniform(0, 90, (12, 4)).astype(np.float32))
    rois[:, 2:] += rois[:, :2]
    bidx = torch.arange(12) % 2
    assigned = torch.arange(12) % 3
    args = (crops, gtb, rois, bidx, assigned)
    want = mask_targets_from_crops(*args)
    got = mask_targets_from_crops(*(a.to(card) for a in args)).cpu()
    assert int((got != want).sum()) <= 4      # ties at 0.5 only
    probs = torch.rand((6, 28, 28), generator=torch.Generator().manual_seed(1))
    boxes = np.asarray([[5, 6, 300, 200], [0, 0, 20, 9], [100, 50, 140, 400],
                        [600, 400, 640, 427], [-4, -3, 70, 90],
                        [10, 10, 11, 11]], np.float32)
    assert torch.equal(paste_masks(probs.to(card), boxes, 427, 640).cpu(),
                       paste_masks(probs, boxes, 427, 640))


@pytest.mark.cuda
def test_tiny_mask_rcnn_predict_on_the_card_matches_the_cpu(card):
    import copy

    from dsl_tpu_torch.models import build_detector
    from dsl_tpu_torch.models.detectors.two_stage import mask_rcnn_predict
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.jax_bridge import (
        flax_to_state_dict, state_dict_to_flax)
    from dsl_tpu_torch.utils.random_weights import fill_variables
    from dsl_tpu_torch.utils.synthetic_data import TINY_MASK_RCNN

    det = build_detector(copy.deepcopy(TINY_MASK_RCNN))
    det.load_state_dict(flax_to_state_dict(fill_variables(
        state_dict_to_flax(det.state_dict()))))
    det.eval()
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 3, 64, 96).astype(np.float32))
    rois = torch.from_numpy(np.random.RandomState(6).randn(
        7, 32, 14, 14).astype(np.float32))
    outs, launches = {}, {}
    for dev in (card, "cpu"):
        d = copy.deepcopy(det).to(dev)
        with torch.no_grad():
            outs[str(dev)] = d(rois.to(dev), stage="mask").cpu()
        before = nms_keep.launches
        mask_rcnn_predict(d, x.to(dev))
        launches[str(dev)] = nms_keep.launches - before
    assert launches["cuda"] == 2 and launches["cpu"] == 0
    want = outs["cpu"]
    torch.testing.assert_close(outs["cuda"], want, rtol=0,
                               atol=1e-4 * max(1.0, float(want.abs().max())))


def _seeded(cfg: dict):
    import copy

    from dsl_tpu_torch.utils.random_weights import fill_variables

    det = build_detector(copy.deepcopy(cfg))
    det.load_state_dict(flax_to_state_dict(fill_variables(
        state_dict_to_flax(det.state_dict()))))
    return det


@pytest.mark.cuda
def test_tiny_cascade_predict_on_the_card_matches_the_cpu(card):
    import copy

    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.utils.synthetic_data import TINY_CASCADE_MASK_RCNN

    det = _seeded(TINY_CASCADE_MASK_RCNN).eval()
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 3, 64, 96).astype(np.float32))
    rois = torch.from_numpy(np.random.RandomState(8).randn(
        9, 32, 14, 14).astype(np.float32))
    outs, launches = {}, {}
    for dev in (card, "cpu"):
        d = copy.deepcopy(det).to(dev)
        with torch.no_grad():
            heads = [d(rois[..., :7, :7].to(dev), stage="roi", head=i)
                     for i in range(3)]
            heads.append(d(rois.to(dev), stage="mask"))
        before = nms_keep.launches
        dets = detector_predict(d, x.to(dev), device=dev)
        launches[str(dev)] = nms_keep.launches - before
        outs[str(dev)] = ([t.cpu() for h in heads for t in (
            h if isinstance(h, tuple) else (h,))], [t.cpu() for t in dets])
    assert launches["cuda"] == 2 and launches["cpu"] == 0
    (got_h, got), (want_h, want) = outs["cuda"], outs["cpu"]
    for g, w in zip(got_h, want_h):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 50
    for i in range(x.shape[0]):
        rows = []
        for d, lab, v in (got, want):
            d, lab = d[i][v[i]].numpy(), lab[i][v[i]].numpy()
            order = np.lexsort((np.round(d[:, 1], 1), np.round(d[:, 0], 1), lab))
            rows.append((d[order], lab[order]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cascade_mask", "mask_scoring"])
def test_tiny_two_stage_loss_on_the_card_matches_the_cpu(card, which,
                                                         monkeypatch):
    import copy

    from dsl_tpu_torch.models.detectors import detector_loss
    from dsl_tpu_torch.models.detectors import two_stage
    from dsl_tpu_torch.utils.synthetic_data import (
        TINY_CASCADE_MASK_RCNN, TINY_MASK_SCORING_RCNN)

    cfg = (TINY_CASCADE_MASK_RCNN if which == "cascade_mask"
           else TINY_MASK_SCORING_RCNN)
    det = _seeded(cfg).train()
    rng = np.random.RandomState(9)
    b, k, m = 2, 4, 112
    gtb = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        for j in range(k):
            x1, y1 = rng.uniform(0, 60), rng.uniform(0, 30)
            gtb[i, j] = (x1, y1, x1 + rng.uniform(8, 36), y1 + rng.uniform(8, 30))
    crops = (rng.rand(b, k, m, m) < 0.5).astype(np.uint8)
    batch = dict(
        images=rng.randn(b, 64, 96, 3).astype(np.float32), gt_bboxes=gtb,
        gt_labels=rng.randint(0, 20, (b, k)), gt_valid=np.ones((b, k), bool),
        gt_mask_crops=crops, img_shapes=np.tile(np.float32([64, 96]), (b, 1)),
        gt_mask_areas=(crops.reshape(b, k, -1).mean(-1) * (gtb[..., 2] - gtb[..., 0])
                       * (gtb[..., 3] - gtb[..., 1])).astype(np.float32))
    real = two_stage.sampler_draws

    def on_host(cur_iter, bs, a, n, device, stages=1):
        draws = real(cur_iter, bs, a, n, "cpu", stages=stages)
        return dict(rpn=draws["rpn"].to(device),
                    rcnn=tuple(x.to(device) for x in draws["rcnn"]))

    monkeypatch.setattr(two_stage, "sampler_draws", on_host)
    got = {}
    for dev in (card, "cpu"):
        before = nms_keep.launches
        _, log_vars = detector_loss(copy.deepcopy(det).to(dev),
                                    to_torch(batch, dev), cur_iter=4)
        got[str(dev)] = ({key: float(v) for key, v in log_vars.items()},
                         nms_keep.launches - before)
    (on_card, n_card), (on_cpu, n_cpu) = got["cuda"], got["cpu"]
    assert n_card == 1 and n_cpu == 0 and set(on_card) == set(on_cpu)
    for key, want in on_cpu.items():
        rtol = 1e-3 if key.startswith(("s1.", "s2.")) else 1e-4
        assert abs(on_card[key] - want) <= rtol * max(abs(want), 1e-3), key


def _dets_as_sets(got, want, extra=None):
    """Per image the valid dets of two predicts sorted alike (label, x1, y1
    rounded): labels equal, boxes and scores within 1e-5 relative and 1e-4,
    and the rows of ``extra`` (per-det tensors, e.g. mask probabilities)
    within 1e-4."""
    for i in range(got[0].shape[0]):
        rows = []
        for out in (got, want):
            v = out[2][i].numpy()
            d, lab = out[0][i].numpy()[v], out[1][i].numpy()[v]
            order = np.lexsort((np.round(d[:, 1], 1), np.round(d[:, 0], 1),
                                lab))
            rows.append((d[order], lab[order],
                         None if extra is None else out[3][i].numpy()[v][order]))
        np.testing.assert_array_equal(rows[0][1], rows[1][1])
        np.testing.assert_allclose(rows[0][0], rows[1][0], rtol=1e-5, atol=1e-4)
        if extra is not None:
            np.testing.assert_allclose(rows[0][2], rows[1][2], rtol=0,
                                       atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["htc", "scnet"])
def test_tiny_htc_and_scnet_on_the_card_match_the_cpu(card, which):
    import copy

    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.utils.synthetic_data import TINY_HTC, TINY_SCNET

    det = _seeded(TINY_HTC if which == "htc" else TINY_SCNET).eval()
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randn(2, 3, 64, 96).astype(np.float32))
    rois = torch.from_numpy(rng.randn(9, 32, 14, 14).astype(np.float32))
    fc = torch.from_numpy(rng.randn(9, 64).astype(np.float32))
    with torch.no_grad():
        levels = [torch.from_numpy(rng.randn(*f.shape).astype(np.float32))
                  for f in det(x)[0]]
    outs, launches = {}, {}
    for dev in (card, "cpu"):
        d = copy.deepcopy(det).to(dev)
        lv = [f.to(dev) for f in levels]
        with torch.no_grad():
            heads = [d(lv, stage="semantic")]
            heads += [d(rois[..., :7, :7].to(dev), stage="roi", head=i,
                        shared=which == "scnet") for i in range(3)]
            if which == "htc":
                res = None
                for j in range(3):
                    out = d(rois.to(dev), stage="htc_mask", head=j,
                            res_feat=res)
                    heads.append(out)
                    res = out[1]
            else:
                heads += [d(lv, stage="glbctx"), d(fc.to(dev), stage="relay"),
                          d(rois.to(dev), stage="mask")]
        before = nms_keep.launches
        dets = detector_predict(d, x.to(dev), device=dev)
        launches[str(dev)] = nms_keep.launches - before
        outs[str(dev)] = ([t.cpu() for h in heads for t in (
            h if isinstance(h, tuple) else (h,))], [t.cpu() for t in dets])
    assert launches["cuda"] == 2 and launches["cpu"] == 0
    (got_h, got), (want_h, want) = outs["cuda"], outs["cpu"]
    for g, w in zip(got_h, want_h):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 50
    _dets_as_sets(got, want, extra=True)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["htc", "scnet"])
def test_tiny_htc_and_scnet_losses_on_the_card_match_the_cpu(card, which,
                                                             monkeypatch):
    import copy

    from dsl_tpu_torch.models.detectors import detector_loss
    from dsl_tpu_torch.models.detectors import two_stage
    from dsl_tpu_torch.utils.synthetic_data import TINY_HTC, TINY_SCNET

    det = _seeded(TINY_HTC if which == "htc" else TINY_SCNET).train()
    rng = np.random.RandomState(11)
    b, k, m = 2, 4, 112
    gtb = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        for j in range(k):
            x1, y1 = rng.uniform(0, 60), rng.uniform(0, 30)
            gtb[i, j] = (x1, y1, x1 + rng.uniform(8, 36), y1 + rng.uniform(8, 30))
    batch = dict(
        images=rng.randn(b, 64, 96, 3).astype(np.float32), gt_bboxes=gtb,
        gt_labels=rng.randint(0, 20, (b, k)), gt_valid=np.ones((b, k), bool),
        gt_mask_crops=(rng.rand(b, k, m, m) < 0.5).astype(np.uint8),
        img_shapes=np.tile(np.float32([64, 96]), (b, 1)))
    real = two_stage.sampler_draws

    def on_host(cur_iter, bs, a, n, device, stages=1):
        draws = real(cur_iter, bs, a, n, "cpu", stages=stages)
        return dict(rpn=draws["rpn"].to(device),
                    rcnn=tuple(x.to(device) for x in draws["rcnn"]))

    monkeypatch.setattr(two_stage, "sampler_draws", on_host)
    got = {}
    for dev in (card, "cpu"):
        before = nms_keep.launches
        _, log_vars = detector_loss(copy.deepcopy(det).to(dev),
                                    to_torch(batch, dev), cur_iter=4)
        got[str(dev)] = ({key: float(v) for key, v in log_vars.items()},
                         nms_keep.launches - before)
    (on_card, n_card), (on_cpu, n_cpu) = got["cuda"], got["cpu"]
    assert n_card == 1 and n_cpu == 0 and set(on_card) == set(on_cpu)
    for key, want in on_cpu.items():
        rtol = (1e-3 if key.startswith(("s1.", "s2.")) or "mask" in key
                or key == "loss" else 1e-4)
        assert abs(on_card[key] - want) <= rtol * max(abs(want), 1e-3), key


@pytest.mark.cuda
def test_resize_and_sac_on_the_card_match_the_cpu_and_repeat(card):
    """Under cuDNN's deterministic algorithms, as ``train_detector`` runs
    its steps (a convolution's backward may add with atomics without
    them)."""
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.models.backbones.detectors_resnet import SAConv
    from dsl_tpu_torch.models.roi_heads.htc import resize_bilinear

    rng = np.random.RandomState(12)
    sac = SAConv(32, 32, stride=2)
    sac.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        sac.weight_diff.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    cases = [
        (lambda t, dev: resize_bilinear(t, (8, 12)),
         rng.randn(2, 16, 17, 23).astype(np.float32), None),
        (lambda t, dev: resize_bilinear(t, (40, 56)),
         rng.randn(2, 16, 5, 7).astype(np.float32), None),
        (lambda t, dev, m=sac: m.to(dev)(t),
         rng.randn(2, 32, 21, 27).astype(np.float32), sac),
    ]
    for fn, x, module in cases:
        got = {}
        for dev in (card, "cpu", card):
            with deterministic_cudnn():
                _forward_backward(fn, x, module, dev, got)
        (c_out, c_grads), (r_out, r_grads) = got["cuda"]
        assert torch.equal(c_out, r_out) and all(
            torch.equal(a, b) for a, b in zip(c_grads, r_grads))
        w_out, w_grads = got["cpu"][0]
        for a, b in zip([c_out] + c_grads, [w_out] + w_grads):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
                1.0, float(b.abs().max())))


_SLICE15 = ("point_rend", "yolact", "seesaw")


def _slice15(which: str):
    from dsl_tpu_torch.utils.synthetic_data import (
        TINY_POINT_REND, TINY_SEESAW, TINY_YOLACT)

    return {"point_rend": TINY_POINT_REND, "yolact": TINY_YOLACT,
            "seesaw": TINY_SEESAW}[which]


def _slice15_heads(d, which: str, dev) -> list:
    """The heads of one slice-15 detector on seeded inputs."""
    from dsl_tpu_torch.models.roi_heads import point_rend as pr
    from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi

    rng = np.random.RandomState(14)
    rois = torch.from_numpy(rng.randn(6, 32, 14, 14).astype(np.float32)).to(dev)
    with torch.no_grad():
        if which == "yolact":
            x = torch.from_numpy(rng.randn(2, 3, 64, 96).astype(np.float32))
            out = d(x.to(dev))
            return [*out[0], *out[1], *out[2], out[3], out[4]]
        mask = d(rois, stage="mask")
        if which == "seesaw":
            logits = torch.from_numpy(rng.randn(9, 22).astype(np.float32))
            return [mask, roi.split_scores(d.bbox_head, logits.to(dev))]
        fine = torch.from_numpy(rng.randn(6, 5, 32).astype(np.float32)).to(dev)
        point = d(fine, stage="point", coarse=torch.from_numpy(
            rng.randn(6, 5, 20).astype(np.float32)).to(dev))
        p2 = torch.from_numpy(rng.randn(2, 32, 16, 24).astype(np.float32))
        boxes = torch.tensor([[[4., 5., 40., 30.]] * 3] * 2)
        refined = pr.point_rend_refine(
            mask.reshape(2, 3, 20, 7, 7), p2.to(dev), boxes.to(dev),
            torch.tensor([[1, 2, 3]] * 2).to(dev),
            lambda f, c: d(f, stage="point", coarse=c), subdivision_steps=1)
        return [mask, point, refined]


@pytest.mark.cuda
@pytest.mark.parametrize("which", _SLICE15)
def test_slice15_heads_and_predicts_on_the_card_match_the_cpu(card, which):
    import copy

    from dsl_tpu_torch.models.dense_heads.yolact_head import (
        yolact_full_predict)
    from dsl_tpu_torch.models.detectors.two_stage import mask_rcnn_predict

    det = _seeded(_slice15(which)).eval()
    x = torch.from_numpy(np.random.RandomState(15).randn(
        2, 3, 64, 96).astype(np.float32))
    predict = yolact_full_predict if which == "yolact" else mask_rcnn_predict
    outs, launches = {}, {}
    for dev in (card, "cpu"):
        d = copy.deepcopy(det).to(dev)
        heads = [h.cpu() for h in _slice15_heads(d, which, dev)]
        before = nms_keep.launches
        out = predict(d, x.to(dev))
        launches[str(dev)] = nms_keep.launches - before
        outs[str(dev)] = (heads, [o.cpu() for o in out])
    assert launches["cuda"] == (0 if which == "yolact" else 2)
    assert launches["cpu"] == 0
    (got_h, got), (want_h, want) = outs["cuda"], outs["cpu"]
    for g, w in zip(got_h, want_h):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    assert torch.equal(got[2], want[2]) and int(got[2].sum()) > 0
    _dets_as_sets(got, want, extra=True)


@pytest.mark.cuda
def test_fast_nms_on_the_card_equals_the_cpu(card):
    from dsl_tpu_torch.core.nms import fast_nms

    rng = np.random.RandomState(16)
    x1, y1 = rng.uniform(0, 400, (4, 3000)), rng.uniform(0, 300, (4, 3000))
    boxes = torch.from_numpy(np.stack(
        [x1, y1, x1 + rng.uniform(8, 120, x1.shape),
         y1 + rng.uniform(8, 120, x1.shape)], -1).astype(np.float32))
    scores = torch.from_numpy(rng.choice(
        [0.01, 0.06, 0.3, 0.8], (4, 3000, 80),
        p=[0.97, 0.01, 0.01, 0.01]).astype(np.float32))
    got = fast_nms(boxes.to(card), scores.to(card))
    want = fast_nms(boxes, scores)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[3].sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("which", _SLICE15)
def test_slice15_losses_on_the_card_match_the_cpu(card, which, monkeypatch):
    import copy

    from dsl_tpu_torch.models.detectors import detector_loss
    from dsl_tpu_torch.models.detectors import two_stage

    det = _seeded(_slice15(which)).train()
    rng = np.random.RandomState(17)
    b, k, m = 2, 4, 112
    gtb = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        for j in range(k):
            x1, y1 = rng.uniform(0, 60), rng.uniform(0, 30)
            gtb[i, j] = (x1, y1, x1 + rng.uniform(8, 36), y1 + rng.uniform(8, 30))
    batch = dict(
        images=rng.randn(b, 64, 96, 3).astype(np.float32), gt_bboxes=gtb,
        gt_labels=rng.randint(0, 20, (b, k)), gt_valid=np.ones((b, k), bool),
        gt_mask_crops=(rng.rand(b, k, m, m) < 0.5).astype(np.uint8),
        img_shapes=np.tile(np.float32([64, 96]), (b, 1)),
        cum_samples=np.exp(rng.uniform(0, 5, 21)).round().astype(np.float32))
    real = two_stage.sampler_draws

    def on_host(cur_iter, bs, a, n, device, **kw):
        draws = real(cur_iter, bs, a, n, "cpu", **kw)
        return {key: (v.to(device) if torch.is_tensor(v)
                      else tuple(x.to(device) for x in v))
                for key, v in draws.items()}

    monkeypatch.setattr(two_stage, "sampler_draws", on_host)
    got = {}
    for dev in (card, "cpu"):
        before = nms_keep.launches
        _, log_vars = detector_loss(copy.deepcopy(det).to(dev),
                                    to_torch(batch, dev), cur_iter=4)
        got[str(dev)] = ({key: float(v) for key, v in log_vars.items()},
                         nms_keep.launches - before)
    (on_card, n_card), (on_cpu, n_cpu) = got["cuda"], got["cpu"]
    assert n_card == (0 if which == "yolact" else 1) and n_cpu == 0
    assert set(on_card) == set(on_cpu)
    for key, want in on_cpu.items():
        rtol = (1e-3 if key in ("loss_mask", "loss_point", "loss")
                else 1e-4)
        assert abs(on_card[key] - want) <= rtol * max(abs(want), 1e-3), key


def _forward_backward(fn, x, module, dev, got: dict):
    """``fn`` on ``x`` on ``dev``, backward of a seeded gradient; the output
    and the gradients (the input's, the module's) appended to
    ``got[dev]``."""
    t = torch.from_numpy(x).to(dev).requires_grad_()
    out = fn(t, dev)
    g = torch.from_numpy(np.random.RandomState(13).randn(
        *out.shape).astype(np.float32)).to(dev)
    out.backward(g)
    grads = [t.grad.cpu()] + ([p.grad.cpu().clone() for p in
                               module.parameters()] if module else [])
    if module is not None:
        module.zero_grad()
    got.setdefault(str(dev), []).append((out.detach().cpu(), grads))


_SLICE16 = ("hrnet_faster", "hrnet_fcos", "regnet", "resnest", "res2net",
            "mobilenet_v2")


def _slice16(which: str):
    from dsl_tpu_torch.utils import synthetic_data as S

    return {"hrnet_faster": S.TINY_HRNET_FASTER,
            "hrnet_fcos": S.TINY_HRNET_FCOS, "regnet": S.TINY_REGNET_MASK,
            "resnest": S.TINY_RESNEST_FASTER,
            "res2net": S.TINY_RES2NET_FASTER,
            "mobilenet_v2": S.TINY_SSD_MOBILENET}[which]


@pytest.mark.cuda
@pytest.mark.parametrize("which", _SLICE16)
def test_slice16_levels_on_the_card_match_the_cpu(card, which):
    import copy

    det = _seeded(_slice16(which)).eval()
    x = torch.from_numpy(np.random.RandomState(16).randn(
        2, 3, 64, 96).astype(np.float32))
    outs = {}
    for dev in (card, "cpu"):
        d = copy.deepcopy(det).to(dev)
        with torch.no_grad():
            feats = d.backbone(x.to(dev))
            outs[str(dev)] = [t.cpu() for t in (*feats, *d.neck(feats))]
    assert len(outs["cuda"]) == 9
    for g, w in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))


@pytest.mark.cuda
def test_hrnet_fuse_and_hrfpn_repeat_on_the_card(card):
    """Under cuDNN's deterministic algorithms, as ``train_detector`` runs
    its steps: the nearest resize and HRFPN's bilinear are matrix products,
    whose backward repeats (a gather's adds with atomics)."""
    import torch.nn.functional as F

    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.models.backbones.hrnet import HRModule
    from dsl_tpu_torch.models.necks.hrfpn import HRFPN
    from dsl_tpu_torch.ops.resize import resize_nearest

    rng = np.random.RandomState(17)
    gen = torch.Generator().manual_seed(0)
    fuse = HRModule(3, (1, 1, 1), (8, 8, 8))
    necks = [HRFPN((8, 8, 8), 16, 4, pooling) for pooling in ("AVG", "MAX")]
    for m in [fuse] + necks:
        for p in m.parameters():
            with torch.no_grad():
                p.normal_(0, 0.3, generator=gen)

    def branches(t):
        # three branches halved from an odd size: 25x37 -> 13x19 -> 7x10
        return [t, F.avg_pool2d(t, 3, 2, 1), F.avg_pool2d(t, 5, 4, 2)]

    cases = [(lambda t, dev: resize_nearest(t, (13, 25)),
              rng.randn(2, 16, 7, 13).astype(np.float32), None),
             (lambda t, dev, m=fuse: torch.cat(
                 [y.flatten(1) for y in m.to(dev)(branches(t))], 1),
              rng.randn(2, 8, 25, 37).astype(np.float32), fuse)]
    cases += [(lambda t, dev, m=neck: torch.cat(
        [y.flatten(1) for y in m.to(dev)(branches(t))], 1),
        rng.randn(2, 8, 32, 48).astype(np.float32), neck) for neck in necks]
    for fn, x, module in cases:
        got = {}
        for dev in (card, "cpu", card):
            with deterministic_cudnn():
                _forward_backward(fn, x, module, dev, got)
        (c_out, c_grads), (r_out, r_grads) = got["cuda"]
        assert torch.equal(c_out, r_out) and all(
            torch.equal(a, b) for a, b in zip(c_grads, r_grads))
        w_out, w_grads = got["cpu"][0]
        for a, b in zip([c_out] + c_grads, [w_out] + w_grads):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
                1.0, float(b.abs().max())))


def _deform_runs(fn, arrays, dev, g, runs: int):
    """``fn`` on ``arrays`` (made tensors on ``dev`` needing a gradient),
    ``runs`` times: each run's output and gradients on the CPU."""
    out_all = []
    for _ in range(runs):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
        out = fn(*ts)
        out.backward(torch.from_numpy(g).to(dev))
        out_all.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    return out_all


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["v1_dilation2", "v2_stride2_dg4_grouped",
                                  "roi_pool_modulated"])
def test_deformable_ops_on_the_card_match_the_cpu_and_repeat(card, case):
    from dsl_tpu_torch.ops.deform_conv import deform_conv2d
    from dsl_tpu_torch.ops.roi_align import deform_roi_align

    rng = np.random.RandomState(15)
    if case == "roi_pool_modulated":
        rois = torch.from_numpy(np.concatenate(
            [rng.randint(0, 2, (40, 1)), rng.rand(40, 2) * 90 - 10,
             rng.rand(40, 2) * 60 + 90], 1).astype(np.float32))
        arrays = [rng.randn(2, 16, 24, 32).astype(np.float32),
                  (1.5 * rng.randn(40, 7, 7, 2)).astype(np.float32),
                  rng.rand(40, 1, 7, 7).astype(np.float32)]

        def fn(f, off, m):
            return deform_roi_align(f, rois.to(f.device), off, (7, 7), 0.25,
                                    2, 0.1) * m
        out_shape = (40, 16, 7, 7)
    else:
        v2 = case != "v1_dilation2"
        stride, dil, dg, groups = (2, 1, 4, 4) if v2 else (1, 2, 1, 1)
        h, w = 21, 27
        oh, ow = -(-h // stride), -(-w // stride)
        arrays = [rng.randn(2, 32, h, w).astype(np.float32),
                  (2.5 * rng.randn(2, dg * 18, oh, ow)).astype(np.float32),
                  (rng.randn(16, 32 // groups, 3, 3) * 0.1).astype(np.float32)]
        if v2:
            arrays.append(rng.rand(2, dg * 9, oh, ow).astype(np.float32))

        def fn(x, off, wt, *m):
            return deform_conv2d(x, off, wt, mask=m[0] if m else None,
                                 stride=stride, dilation=dil,
                                 deform_groups=dg)
        out_shape = (2, 16, oh, ow)
    g = rng.randn(*out_shape).astype(np.float32)
    on_card = _deform_runs(fn, arrays, card, g, 2)
    on_cpu = _deform_runs(fn, arrays, "cpu", g, 1)[0]
    assert all(torch.equal(a, b) for a, b in zip(*on_card))
    for a, b in zip(on_card[0], on_cpu):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
            1.0, float(b.abs().max())))


def _plugin_neck_case(case: str):
    """(fn(*tensors, dev), numpy inputs, output shape, module or None)."""
    rng = np.random.RandomState(18)
    if case == "carafe":
        from dsl_tpu_torch.ops.misc_ops import carafe

        x = rng.randn(2, 16, 13, 21).astype(np.float32)
        m = np.exp(rng.randn(2, 25, 26, 42))
        m = (m / m.sum(1, keepdims=True)).astype(np.float32)
        return (lambda xt, mt, dev: carafe(xt, mt, 5, 2)), [x, m], \
            (2, 16, 26, 42), None
    if case == "generalized_attention":
        from dsl_tpu_torch.models.layers import GeneralizedAttention

        module = GeneralizedAttention(64, num_heads=8, attention_type="1111",
                                      kv_stride=2, spatial_range=3)
        gen = torch.Generator().manual_seed(18)
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        x = rng.randn(2, 64, 25, 37).astype(np.float32)
        return (lambda xt, dev: module.to(dev)(xt)), [x], (2, 64, 25, 37), \
            module
    from dsl_tpu_torch.models.necks.nas_fpn import _resize_to

    x = rng.randn(2, 16, 13, 21).astype(np.float32)
    y = rng.randn(2, 16, 52, 84).astype(np.float32)
    return (lambda xt, yt, dev: torch.cat(
        [_resize_to(xt, (52, 84)).flatten(1),
         _resize_to(yt, (13, 21)).flatten(1)], 1)), [x, y], \
        (2, 16 * (52 * 84 + 13 * 21)), None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["carafe", "generalized_attention",
                                  "nas_fpn_resize"])
def test_plugin_and_neck_ops_on_the_card_match_the_cpu_and_repeat(card, case):
    fn, arrays, out_shape, module = _plugin_neck_case(case)
    g = np.random.RandomState(19).randn(*out_shape).astype(np.float32)
    runs = {}
    for key, dev, n in (("card", card, 2), ("cpu", "cpu", 1)):
        runs[key] = []
        for _ in range(n):
            ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
            if module is not None:
                module.to(dev).zero_grad(set_to_none=True)
            out = fn(*ts, dev)
            out.backward(torch.from_numpy(g).to(dev))
            params = [] if module is None else [
                p.grad.detach().cpu().clone() for p in module.parameters()]
            runs[key].append([out.detach().cpu()]
                             + [t.grad.cpu() for t in ts] + params)
    first, second = runs["card"]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for a, b in zip(first, runs["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
            1.0, float(b.abs().max())))


@pytest.mark.cuda
def test_the_smokes_trace_walk_matches_torchs_event_tree(card):
    """``chip_smoke.py`` reads a trace's raw records (``trace_events``,
    ``range_kernel_us``) where ``prof.events()`` would first build torch's
    event tree (seconds of host time for a traced step): the kernels'
    total and each ``record_function`` range's kernel time, forward and in
    autograd's backward thread, agree with the tree's within 1e-3."""
    import sys
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    class Ranged(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return x @ w

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            with record_function("r"):
                return g @ w.t(), x.t() @ g

    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(512, 512, device=card, generator=gen, requires_grad=True)
    w = torch.randn(512, 512, device=card, generator=gen, requires_grad=True)

    def fn():
        with record_function("r"):
            y = torch.relu(Ranged.apply(x, w))
        (y * y).sum().backward()

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    events = chip_smoke.trace_events(prof)
    ranges = sorted((e for e in events if e.name == "r"
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: e.start)
    ours = chip_smoke.range_kernel_us(events, ranges)
    tree = prof.events()
    theirs = [e.device_time_total for e in sorted(
        (e for e in tree if e.name == "r" and e.device_type == DeviceType.CPU),
        key=lambda e: e.time_range.start)]
    assert len(ranges) == len(theirs) == 6
    assert len({r.thread for r in ranges}) == 2
    assert all(t > 0 for t in theirs)
    for a, b in zip(ours, theirs):
        assert abs(a - b) <= 1e-3 * b
    kernels = [e.end - e.start for e in events
               if e.device_type == DeviceType.CUDA and e.name != "r"]
    want = [e.time_range.elapsed_us() for e in tree
            if e.device_type == DeviceType.CUDA and e.name != "r"]
    assert len(kernels) == len(want)
    assert abs(sum(kernels) - sum(want)) <= 1e-3 * sum(want)
