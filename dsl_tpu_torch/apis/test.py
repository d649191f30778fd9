"""Dataset-wide inference, its evaluation, and test-time augmentation.

Counterpart of ``dsl_tpu/apis/test.py`` (``single_device_test``,
``tta_test``, ``tta_test_dense``, ``merge_aug_detections``) for the
ported detectors (FCOS, RetinaNet, SSD, YOLACT, the two-stage detectors and
Cascade R-CNN; ``tta_test_dense`` is FCOS's). In ``single_device_test`` each image is read onto the device
(``data/image_io.read_image``, nvJPEG on the card), resized keeping its
ratio to ``img_scale`` (``resize_linear_u8``, exact to ``cv2.resize``), normalized
and padded top-left onto the canvas ``formatting.select_canvas`` picks from
the batch's resized images, as the JAX package does, so each image is
predicted on the same canvas in both packages. Batches of ``BATCH_SIZE``
go through ``detector_predict`` (NMS through the CUDA kernel); the JAX
package pads the last batch to a fixed shape, the port predicts its real
rows only (FCOS predicts each image on its own). The results stay on the
device until the last batch is queued. ``flip`` mirrors each decoded
image before its resize, and the detections stay in the mirrored frame.
A Mask R-CNN (``MaskRCNN`` and ``MaskScoringRCNN``, as the JAX package
names them: the C4 form, PointRend and Cascade Mask R-CNN are tested for
their boxes, as there; HTC and SCNet, whose predicts give masks too, are
tested for their boxes here, where the JAX function, whose list does not
name them, fails to unpack their four outputs) predicts through
``two_stage.mask_rcnn_predict``, YOLACT through
``yolact_head.yolact_full_predict`` (56x56 crops, no NMS kernel); after the
last batch is queued, each image's probabilities are pasted at its boxes in
the original size on
the device (``mask_head.paste_masks``), copied out and encoded as
uncompressed RLEs (``core/masks.encode_rle``) one image at a time, so no
image's full-size masks outlive its encoding: its result is (dets, labels,
RLEs), which ``CocoDataset.evaluate`` reads for ``segm`` (the JAX package
keeps the (N, H, W) arrays). :func:`tta_test_masks` re-runs the mask head
per (scale, flip) at :func:`tta_test`'s merged boxes, in batches of 4 as
the JAX function does, averages the unflipped probabilities and pastes
them likewise.

The test-time augmentations run one pass per (scale, flip) and merge on
the host in numpy, as the JAX package does (with the port's copy of its
greedy NMS, ``train/label_store.numpy_nms``): :func:`tta_test` merges each
pass's detections per class; :func:`tta_test_dense`, the reference's
dense-head merge, gathers each pass's raw ``nms_pre`` candidates (no NMS
kernel) and runs one multiclass NMS with the centerness factors.

Data parallelism (``group``, a process group of ``W`` ranks): batch ``b``
of the single process's batches is predicted by rank ``b mod W`` (each
batch keeps its canvas), the per-image results are gathered in dataset
order on every rank (``parallel.dist.all_gather_objects``), and rank 0
evaluates: the metrics are the single process's, and the other ranks get
None. The JAX package runs the whole test in one process over its mesh.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from dsl_tpu_torch.core.masks import encode_rle
from dsl_tpu_torch.data.formatting import DEFAULT_CANVAS, select_canvas
from dsl_tpu_torch.data.pipelines.transforms import read_resized
from dsl_tpu_torch.models.detectors.single_stage import detector_predict
from dsl_tpu_torch.parallel.dist import all_gather_objects
from dsl_tpu_torch.train.label_store import numpy_nms
from dsl_tpu_torch.utils.device import resolve_device, to_device

DEFAULT_NORM = dict(mean=(123.675, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375), to_rgb=True)
BATCH_SIZE = 8                # images per predict, as the JAX package's
MASK_TTA_BATCH = 4            # tta_test_masks' batch_size in the JAX package
# the detectors whose test results carry masks: the JAX package's list (a
# Cascade Mask R-CNN's and a PointRend's are boxes, as in JAX; an HTC's and
# an SCNet's too, where the JAX function raises)
MASK_RESULTS = ("MaskRCNN", "MaskScoringRCNN", "YOLACT")


def _path(dataset, idx: int) -> str:
    name = dataset.data_infos[idx]["filename"]
    return osp.join(dataset.img_prefix, name) if dataset.img_prefix else name


def normalize_pad(imgs: list[torch.Tensor], canvas_hw, img_norm) -> torch.Tensor:
    """(B, 3, H, W) f32: each image normalized (BGR -> RGB where asked) and
    put top-left on a zero canvas."""
    ch, cw = canvas_hw
    device = imgs[0].device
    mean, std = (to_device(torch.tensor(img_norm[k], dtype=torch.float32),
                           device) for k in ("mean", "std"))
    out = torch.zeros((len(imgs), ch, cw, 3), dtype=torch.float32, device=device)
    for i, img in enumerate(imgs):
        x = img.float()
        if img_norm.get("to_rgb", True):
            x = x.flip(-1)
        nh, nw = min(x.shape[0], ch), min(x.shape[1], cw)
        out[i, :nh, :nw] = ((x - mean) / std)[:nh, :nw]
    return out.permute(0, 3, 1, 2).contiguous()


def _rank_world(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return torch.distributed.get_rank(group), torch.distributed.get_world_size(group)


def _gathered(own: dict, group, n: int) -> list:
    """Per-image values in dataset order from every rank's ``{index:
    value}``."""
    if group is not None:
        own = {i: v for part in all_gather_objects(own) for i, v in part.items()}
    return [own[i] for i in range(n)]


def _batches(dataset, img_scale, canvas_hw, norm, device, flip: bool,
             group=None, batch_size: int = BATCH_SIZE):
    """Per batch of ``batch_size`` (this rank's, under ``group``):
    (indices, the resized images' preps (image, [nh, nw], scale factor),
    normalized canvas (B, 3, H, W), img_shapes (B, 2), scale_factors (B, 4)
    on the device)."""
    rank, world = _rank_world(group)
    for b, start in enumerate(range(0, len(dataset), batch_size)):
        if b % world != rank:
            continue
        idxs = list(range(start, min(start + batch_size, len(dataset))))
        preps = [read_resized(_path(dataset, i), img_scale, device, flip=flip)
                 for i in idxs]
        canvas = select_canvas([p[0].shape[:2] for p in preps], canvas_hw)
        images = normalize_pad([p[0] for p in preps], canvas, norm)
        shapes, sfs = (to_device(torch.tensor([p[k] for p in preps],
                                              dtype=torch.float32), device)
                       for k in (1, 2))
        yield idxs, preps, images, shapes, sfs


def single_device_test(detector, params, dataset, test_cfg=None,
                       canvas_hw=DEFAULT_CANVAS, img_scale=(1333, 800),
                       img_norm=None, return_results: bool = False,
                       evaluate: bool = True, flip: bool = False,
                       boxes_only: bool = False,
                       device: str | torch.device = "cuda", group=None):
    """Predict every image of ``dataset``; returns its bbox metrics (and
    segm for a Mask R-CNN), and/or the per-image ``(dets (N, 5), labels
    (N,))`` host arrays (a Mask R-CNN's with the masks' RLEs third); under
    ``group`` the metrics on rank 0, None on the others, and the results of
    every image on every rank.
    ``params`` (name -> tensor, e.g. the EMA teacher's) replaces the
    detector's parameters, as in ``detector_predict``; None keeps them.
    ``flip`` predicts each image mirrored (boxes in the mirrored frame);
    ``boxes_only`` gives a mask detector's boxes alone, as in JAX."""
    det_name = type(detector).__name__
    with_masks = det_name in MASK_RESULTS and not boxes_only
    device = resolve_device(device)
    norm = img_norm or DEFAULT_NORM
    if with_masks:
        from dsl_tpu_torch.models.dense_heads.yolact_head import (
            yolact_full_predict)
        from dsl_tpu_torch.models.detectors.two_stage import mask_rcnn_predict
        from dsl_tpu_torch.utils.precision import to_compute

        mask_predict = (yolact_full_predict if det_name == "YOLACT"
                        else mask_rcnn_predict)

        def predict(images, shapes, sfs):
            return mask_predict(
                detector, images, img_shapes=shapes, scale_factors=sfs,
                test_cfg=test_cfg, variables=None if params is None
                else to_compute(detector, images, None, params)[0])
    else:
        def predict(images, shapes, sfs):
            return detector_predict(detector, images, img_shapes=shapes,
                                    scale_factors=sfs, test_cfg=test_cfg,
                                    device=device, params=params)
    outs = [(idxs, predict(images, shapes, sfs))
            for idxs, _, images, shapes, sfs in _batches(
                dataset, img_scale, canvas_hw, norm, device, flip, group)]
    own = {}
    for idxs, tensors in outs:
        dets, labels, valid = (t.cpu().numpy() for t in tensors[:3])
        for bi, i in enumerate(idxs):
            keep = valid[bi]
            own[i] = (dets[bi][keep].astype(np.float32), labels[bi][keep])
            if with_masks:
                own[i] += (pasted_rles(tensors[3][bi][tensors[2][bi]],
                                       own[i][0], dataset.data_infos[i]),)
    del outs
    results = _gathered(own, group, len(dataset))
    if not evaluate:
        return results
    if _rank_world(group)[0] != 0:
        return (None, results) if return_results else None
    metrics = dataset.evaluate(
        results, metric=["bbox", "segm"] if with_masks else "bbox",
        verbose=False)
    if return_results:
        return metrics, results
    return metrics


def pasted_rles(probs: torch.Tensor, dets: np.ndarray, info: dict) -> list:
    """One image's (N, S, S) mask probabilities pasted at its (N, 5) host
    dets in the original ``info["height"]`` x ``info["width"]`` on their
    device, copied out and encoded: N uncompressed RLEs."""
    from dsl_tpu_torch.models.roi_heads.mask_head import paste_masks

    masks = paste_masks(probs, dets, info["height"], info["width"])
    return [encode_rle(m) for m in masks.cpu().numpy()]


def _multiclass_nms_np(boxes, scores, factors, score_thr, iou_threshold,
                       max_per_img):
    """mmdet's ``multiclass_nms`` on the host: candidates are the raw scores
    above ``score_thr``; ``factors`` (P,) or None multiply after the
    threshold; greedy NMS with each class offset by ``(max + 1) * class``;
    the first ``max_per_img`` kept. boxes (P, 4), scores (P, C).

    The offset keeps classes apart, so the greedy pass runs class by class
    on the offset boxes, each stopping at ``max_per_img`` keeps (no later
    one of its class can reach the first ``max_per_img``), and the keeps
    are merged in the global score order (stable): the JAX package's
    result, at a fraction of one pass over every candidate."""
    cand = scores > score_thr
    ranked = scores * factors[:, None] if factors is not None else scores
    pi, ci = np.nonzero(cand)
    if len(pi) == 0:
        return np.zeros((0, 5), np.float32), np.zeros((0,), np.int64)
    bx = boxes[pi]
    sc = ranked[pi, ci].astype(np.float32)
    shifted = bx + (bx.max() + 1.0) * ci[:, None].astype(np.float32)
    keep = np.sort(np.concatenate([
        idx[numpy_nms(shifted[idx], sc[idx], iou_threshold,
                      max_keep=max_per_img)]
        for idx in (np.flatnonzero(ci == c) for c in np.unique(ci))]))
    keep = keep[np.argsort(-sc[keep], kind="mergesort")][:max_per_img]
    return (np.concatenate([bx[keep], sc[keep, None]], axis=1),
            ci[keep].astype(np.int64))


def merge_aug_detections(per_aug, iou_threshold: float = 0.5,
                         max_per_img: int = 100):
    """One image's detections across augmentations, each already in the
    original frame: concatenated, greedy NMS per class, the highest
    ``max_per_img`` by score."""
    dets = np.concatenate([r[0] for r in per_aug], axis=0)
    labels = np.concatenate([r[1] for r in per_aug], axis=0)
    if len(dets) == 0:
        return dets, labels
    keep = np.concatenate([
        idx[numpy_nms(dets[idx, :4], dets[idx, 4], iou_threshold)]
        for idx in (np.where(labels == c)[0] for c in np.unique(labels))])
    order = keep[np.argsort(-dets[keep, 4])][:max_per_img]
    return dets[order], labels[order]


def _passes(img_scales, flip: bool):
    return [(scale, flipped) for scale in img_scales
            for flipped in ((False, True) if flip else (False,))]


def tta_test(detector, params, dataset, test_cfg=None,
             img_scales=((1333, 800),), flip: bool = True,
             canvas_hw=DEFAULT_CANVAS, img_norm=None,
             iou_threshold: float = 0.5, max_per_img: int = 100,
             evaluate: bool = True, device: str | torch.device = "cuda",
             group=None):
    """Multi-scale and flip test-time augmentation: one
    :func:`single_device_test` pass per (scale, flip), a flipped pass's
    boxes mirrored back with the original image width, then
    :func:`merge_aug_detections` per image. Returns the bbox metrics, or
    the merged per-image results with ``evaluate=False`` (under ``group``
    as :func:`single_device_test` returns them)."""
    aug_results = []
    for scale, flipped in _passes(img_scales, flip):
        res = single_device_test(
            detector, params, dataset, test_cfg=test_cfg, canvas_hw=canvas_hw,
            img_scale=scale, img_norm=img_norm, evaluate=False, flip=flipped,
            boxes_only=True, device=device, group=group)
        if flipped:
            for i, (dets, _) in enumerate(res):
                w = dataset.data_infos[i]["width"]
                dets[:, 0], dets[:, 2] = w - dets[:, 2], w - dets[:, 0]
        aug_results.append(res)
    merged = [merge_aug_detections([aug[i] for aug in aug_results],
                                   iou_threshold=iou_threshold,
                                   max_per_img=max_per_img)
              for i in range(len(dataset))]
    if not evaluate:
        return merged
    if _rank_world(group)[0] != 0:
        return None
    return dataset.evaluate(merged, metric="bbox", verbose=False)


def tta_test_dense(detector, params, dataset, test_cfg=None,
                   img_scales=((1333, 800),), flip: bool = True,
                   canvas_hw=DEFAULT_CANVAS, img_norm=None,
                   evaluate: bool = True, device: str | torch.device = "cuda",
                   group=None):
    """The reference's dense-head test-time augmentation
    (``aug_test_bboxes`` with ``merge_aug_bboxes``): each (scale, flip)
    pass gives its raw ``nms_pre`` candidates per image
    (``detector_predict(with_nms=False)``: no NMS kernel), mirrored back
    in the resized frame with that image's resized width, then divided by
    its scale factor; the candidates of all passes go through one
    :func:`_multiclass_nms_np` with the centerness factors (under
    ``group`` each rank merges its batches' images, then the merged results
    are gathered). FCOS-family heads only."""
    head = type(detector.bbox_head).__name__
    if head not in ("FCOSHead", "NASFCOSHead"):
        raise NotImplementedError(f"tta_test_dense: {head}: FCOS-family "
                                  f"heads only")
    device = resolve_device(device)
    norm = img_norm or DEFAULT_NORM
    tc = dict(test_cfg or detector.test_cfg or {})
    cand = {}
    for scale, flipped in _passes(img_scales, flip):
        for idxs, preps, images, shapes, _ in _batches(
                dataset, scale, canvas_hw, norm, device, flipped, group):
            boxes, scores, cent = (t.cpu().numpy() for t in detector_predict(
                detector, images, img_shapes=shapes, test_cfg=tc,
                device=device, params=params, with_nms=False))
            for bi, i in enumerate(idxs):
                bx = boxes[bi].copy()
                if flipped:
                    iw = np.float32(preps[bi][1][1])
                    bx[:, 0], bx[:, 2] = iw - bx[:, 2], iw - bx[:, 0]
                bx /= np.asarray(preps[bi][2], np.float32)
                cand.setdefault(i, []).append((bx, scores[bi], cent[bi]))
    merged = _gathered({i: _multiclass_nms_np(
        np.concatenate([c[0] for c in cs]), np.concatenate([c[1] for c in cs]),
        np.concatenate([c[2] for c in cs]), tc.get("score_thr", 0.05),
        dict(tc.get("nms", {}) or {}).get("iou_threshold", 0.6),
        tc.get("max_per_img", 100)) for i, cs in cand.items()}, group,
        len(dataset))
    if not evaluate:
        return merged
    if _rank_world(group)[0] != 0:
        return None
    return dataset.evaluate(merged, metric="bbox", verbose=False)


def tta_test_masks(detector, params, dataset, merged,
                   img_scales=((1333, 800),), flip: bool = True,
                   canvas_hw=DEFAULT_CANVAS, img_norm=None,
                   max_per_img: int = 100,
                   device: str | torch.device = "cuda"):
    """Mask test-time augmentation (mmdet's ``aug_test_mask`` /
    ``merge_aug_masks``): per (scale, flip) pass, in batches of
    ``MASK_TTA_BATCH``, the mask head at the same merged boxes (original
    frame, scaled to the pass's and mirrored where flipped), the
    probabilities of each box's label unflipped and summed on the device;
    their mean is pasted at the boxes in the original size.

    ``merged``: per image (dets, labels) from :func:`tta_test`
    (``evaluate=False``), at most ``max_per_img`` each used. Returns per
    image (dets, labels, RLEs)."""
    from dsl_tpu_torch.models.detectors.two_stage import (
        _caller, class_probs, mask_logits_for_boxes)
    from dsl_tpu_torch.utils.precision import to_compute

    device = resolve_device(device)
    norm = img_norm or DEFAULT_NORM
    n_img, nmax = len(dataset), max_per_img
    boxes0 = np.zeros((n_img, nmax, 4), np.float32)
    labels0 = np.zeros((n_img, nmax), np.int64)
    valid0 = np.zeros((n_img, nmax), bool)
    for i, (d, lab) in enumerate(merged):
        m = min(len(d), nmax)
        boxes0[i, :m] = d[:m, :4]
        labels0[i, :m] = lab[:m]
        valid0[i, :m] = True
    acc, n_aug = [None] * n_img, 0
    for scale, flipped in _passes(img_scales, flip):
        n_aug += 1
        for idxs, preps, images, _, _ in _batches(
                dataset, scale, canvas_hw, norm, device, flipped,
                batch_size=MASK_TTA_BATCH):
            sfs = np.stack([np.asarray(p[2], np.float32) for p in preps])
            bx = boxes0[idxs] * sfs[:, None, :]            # the input's frame
            if flipped:
                ws = np.asarray([p[1][1] for p in preps], np.float32)
                bx[:, :, 0], bx[:, :, 2] = (ws[:, None] - bx[:, :, 2],
                                            ws[:, None] - bx[:, :, 0])
            call = _caller(detector, None if params is None else to_compute(
                detector, images, None, params)[0])
            with torch.no_grad():
                feats = call(images)[0]
                logits = mask_logits_for_boxes(
                    detector, feats, to_device(torch.from_numpy(bx), device),
                    to_device(torch.from_numpy(valid0[idxs]), device), call)
                probs = class_probs(
                    logits, to_device(torch.from_numpy(labels0[idxs]), device),
                    detector.mask_head.num_classes)
            s = probs.shape[-1]
            probs = probs.reshape(len(idxs), nmax, s, s)
            if flipped:
                probs = probs.flip(-1)
            for j, i in enumerate(idxs):
                acc[i] = probs[j] if acc[i] is None else acc[i] + probs[j]
    results = []
    for i, (d, lab) in enumerate(merged):
        m = min(len(d), nmax)
        # a division by a device tensor, as numpy's (not a reciprocal)
        avg = acc[i][:m] / acc[i].new_full((), float(max(n_aug, 1)))
        results.append((d[:m], lab[:m],
                        pasted_rles(avg, d[:m], dataset.data_infos[i])))
    return results
