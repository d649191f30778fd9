"""Single-image inference API.

Counterpart of ``dsl_tpu/apis/inference.py``: ``init_detector`` builds the
detector, loads a checkpoint into it and returns a bundle;
``inference_detector(bundle, img)`` takes a path or a BGR uint8 ndarray and
returns per-class box lists (the mmdet result format: a list of C arrays of
shape (n_i, 5)).

A path is read by ``data/image_io.read_image`` on the detector's device
(nvJPEG on the card, ``cv2.imread`` on the CPU). Resize and normalize run in
torch there (``image_ops.resize_linear_u8``, bit for bit ``cv2.resize``;
then the BGR->RGB flip and mean/std), so the serving machine needs no
OpenCV.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dsl_tpu_torch.config import Config
from dsl_tpu_torch.data.image_io import read_image
from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
from dsl_tpu_torch.models import build_detector, detector_predict
from dsl_tpu_torch.models.detectors.single_stage import empty_detector
from dsl_tpu_torch.models.detectors.cascade_rcnn import roi_bbox_head_cfg
from dsl_tpu_torch.utils.checkpoint import load_weights
from dsl_tpu_torch.utils.device import resolve_device
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict

# Resize(1333, 800) + pad to a multiple of 32
DEFAULT_CANVAS = (800, 1344)
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)


class DetectorBundle:
    def __init__(self, detector, cfg, canvas_hw=DEFAULT_CANVAS):
        self.detector = detector
        self.cfg = cfg
        self.canvas_hw = tuple(canvas_hw)
        self.device = next(detector.parameters()).device


def load_detector(model_cfg: dict, checkpoint: str | None = None,
                  ema: bool = True, variables: dict | None = None):
    """The detector of ``model_cfg`` on the CPU with ``checkpoint`` loaded
    (``utils/checkpoint.load_weights``: a weights file, a
    ``train_detector`` checkpoint's EMA teacher, or its student where
    ``ema`` is False, or an mmdet-layout ``.pth``); without one, the
    weights are ``variables`` (a flax ``{"params", "batch_stats"}`` tree of
    numpy arrays, through the weight bridge) or the modules' random init
    from seed 0. A checkpoint that does not load raises (the JAX package
    keeps its random init). The backbone's ``pretrained`` file is not read:
    the checkpoint holds the weights, as in mmdet's ``init_detector``."""
    model = dict(model_cfg)
    if "pretrained" in model["backbone"]:
        # (a backbone without the option, ResNeSt's, keeps none)
        model["backbone"] = {**dict(model["backbone"]), "pretrained": None}
    if checkpoint:
        # both loads set every parameter and buffer or raise
        detector = empty_detector(model)
        load_weights(checkpoint, detector, ema=ema)
    elif variables is not None:
        detector = empty_detector(model)
        detector.load_state_dict(flax_to_state_dict(variables))
    else:
        detector = build_detector(model)
        detector.init_weights(torch.Generator().manual_seed(0))
    return detector


def init_detector(config, checkpoint: str | None = None,
                  device: str | torch.device = "cuda", canvas_hw=None,
                  variables: dict | None = None) -> DetectorBundle:
    """Build the detector of ``config`` (a path or a Config) with
    ``checkpoint`` (or ``variables``) loaded, as :func:`load_detector`
    does, on ``device``."""
    device = resolve_device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    if canvas_hw is None:
        canvas_hw = tuple(config.get("canvas_hw", DEFAULT_CANVAS))
    detector = load_detector(config.model, checkpoint, variables=variables)
    return DetectorBundle(detector.to(device).eval(), config, canvas_hw)


def preprocess(bundle: DetectorBundle, img):
    """BGR HWC image (ndarray or tensor) -> (canvas (1, 3, H, W),
    img_shapes (1, 2), scale_factors (1, 4)) on the bundle's device."""
    h, w = img.shape[:2]
    ch, cw = bundle.canvas_hw
    factor = min(1344 / max(h, w), 800 / min(h, w))
    nw, nh = int(w * factor + 0.5), int(h * factor + 0.5)
    img = torch.as_tensor(np.ascontiguousarray(img) if isinstance(
        img, np.ndarray) else img).to(bundle.device)
    out = resize_linear_u8(img, nh, nw).permute(2, 0, 1)[None].float()
    mean = torch.tensor(IMG_MEAN, device=bundle.device)[None, :, None, None]
    std = torch.tensor(IMG_STD, device=bundle.device)[None, :, None, None]
    out = (out.flip(1) - mean) / std
    canvas = out.new_zeros((1, 3, ch, cw))
    canvas[:, :, :min(nh, ch), :min(nw, cw)] = out[:, :, :ch, :cw]
    sf = torch.tensor([[nw / w, nh / h, nw / w, nh / h]], dtype=torch.float32,
                      device=bundle.device)
    shapes = torch.tensor([[nh, nw]], dtype=torch.float32, device=bundle.device)
    return canvas, shapes, sf


def inference_detector(bundle: DetectorBundle, img):
    """img: file path or BGR ndarray. Returns a list per class of (n, 5)
    (a cascade's classes are its last stage's, an HTC's and an SCNet's
    boxes without their masks; the JAX function reads a ``bbox_head`` and
    raises on a cascade config)."""
    if isinstance(img, (str, os.PathLike)):
        img = read_image(img, bundle.device)
    canvas, shapes, sf = preprocess(bundle, img)
    dets, labels, valid = detector_predict(
        bundle.detector, canvas, img_shapes=shapes, scale_factors=sf,
        test_cfg=dict(bundle.cfg.model.get("test_cfg", {}) or {}),
        device=bundle.device)[:3]
    keep = valid[0].cpu().numpy()
    dets = dets[0].cpu().numpy()[keep]
    labels = labels[0].cpu().numpy()[keep]
    num_classes = roi_bbox_head_cfg(bundle.cfg.model)["num_classes"]
    return [dets[labels == c] for c in range(num_classes)]
