"""Dataset-wide inference and its COCO evaluation (boxes).

Counterpart of ``dsl_tpu/apis/test.py::single_device_test`` for the
single-stage detectors: each image is read onto the device
(``data/image_io.read_image``, nvJPEG on the card), resized keeping its
ratio to ``img_scale`` (``resize_linear_u8``, exact to ``cv2.resize``), normalized
and padded top-left onto the canvas ``formatting.select_canvas`` picks from
the batch's resized images, as the JAX package does, so each image is
predicted on the same canvas in both packages. Batches of ``BATCH_SIZE``
go through ``detector_predict`` (NMS through the CUDA kernel); the JAX
package pads the last batch to a fixed shape, the port predicts its real
rows only (FCOS predicts each image on its own). The results stay on the
device until the last batch is queued. Instance masks (Mask R-CNN,
YOLACT) are not ported and raise.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from dsl_tpu_torch.data.formatting import DEFAULT_CANVAS, select_canvas
from dsl_tpu_torch.data.pipelines.transforms import read_resized
from dsl_tpu_torch.models.detectors.single_stage import detector_predict
from dsl_tpu_torch.utils.device import resolve_device, to_device

DEFAULT_NORM = dict(mean=(123.675, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375), to_rgb=True)
BATCH_SIZE = 8                # images per predict, as the JAX package's


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


def single_device_test(detector, params, dataset, test_cfg=None,
                       canvas_hw=DEFAULT_CANVAS, img_scale=(1333, 800),
                       img_norm=None, return_results: bool = False,
                       evaluate: bool = True,
                       device: str | torch.device = "cuda"):
    """Predict every image of ``dataset``; returns its COCO bbox metrics
    (and/or the per-image ``(dets (N, 5), labels (N,))`` host arrays).
    ``params`` (name -> tensor, e.g. the EMA teacher's) replaces the
    detector's parameters, as in ``detector_predict``; None keeps them."""
    det_name = type(detector).__name__
    if det_name in ("MaskRCNN", "MaskScoringRCNN", "YOLACT"):
        raise NotImplementedError(f"single_device_test: {det_name} predicts "
                                  f"instance masks, which are not ported yet")
    device = resolve_device(device)
    norm = img_norm or DEFAULT_NORM
    outs = []
    for start in range(0, len(dataset), BATCH_SIZE):
        preps = [read_resized(_path(dataset, i), img_scale, device)
                 for i in range(start, min(start + BATCH_SIZE, len(dataset)))]
        canvas = select_canvas([p[0].shape[:2] for p in preps], canvas_hw)
        images = normalize_pad([p[0] for p in preps], canvas, norm)
        shapes, sfs = (to_device(torch.tensor([p[k] for p in preps],
                                              dtype=torch.float32), device)
                       for k in (1, 2))
        outs.append(detector_predict(
            detector, images, img_shapes=shapes, scale_factors=sfs,
            test_cfg=test_cfg, device=device, params=params))
    results = []
    for dets, labels, valid in outs:
        dets, labels, valid = (t.cpu().numpy() for t in (dets, labels, valid))
        for bi in range(len(dets)):
            results.append((dets[bi][valid[bi]].astype(np.float32),
                            labels[bi][valid[bi]]))
    if not evaluate:
        return results
    metrics = dataset.evaluate(results, metric="bbox", verbose=False)
    if return_results:
        return metrics, results
    return metrics
