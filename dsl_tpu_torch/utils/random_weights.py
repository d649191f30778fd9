"""Seeded numpy weights in the flax variable layout, for smoke runs and
parity tests (no pretrained checkpoint ships with the repo).

``fill_variables`` takes a tree whose leaves have a ``.shape`` (flax
``ShapeDtypeStruct``s from ``jax.eval_shape``, or the arrays of
``state_dict_to_flax``) and returns float32 arrays:

- conv kernels: normals with variance 1/fan_in, so activations stay O(1)
  through the depth;
- norm scales near 1, biases small, BN means small and variances in
  [0.5, 1.5] (positive, as real statistics are);
- the classifier: a small kernel and a bias per class, ``LIVE_CLASSES``
  classes with scores well above ``score_thr`` (logits in [-1.5, 1]) and
  the rest far below it (-8), so predict has many candidates for NMS and
  none lies near the threshold;
- the box regressor: a small kernel and biases in [1.5, 3], so boxes span
  a few strides and neighbouring points' boxes overlap past the NMS
  threshold, as real detections do (random relu'd distances would give
  thin boxes that suppress nothing);
- RetinaNet's classifier (``retina_cls``, A x C channels, class = channel
  mod C) as FCOS's, and its regressor (``retina_reg``) small, so boxes
  stay near their anchors, which overlap as real detections do;
- the RPN's regressor (``rpn_reg``) small, so proposals stay near their
  anchors; its objectness keeps the plain fill (logits of order 1);
- the RoI head's classifier (``fc_cls``, C + 1 outputs, background last):
  a small kernel, ``LIVE_CLASSES`` classes at logits in [1, 2], the
  background at 0 and the rest at -8, so each proposal's softmax puts
  about 1/9 on each live class, above ``score_thr`` 0.05 (8 (proposal,
  class) candidates per proposal, so the RoI NMS sees its full 2000);
  its regressor (``fc_reg``) small, so class boxes stay near the
  proposals; under SeesawLoss (C + 2 outputs beside a regressor of 4C) the
  same class logits, the positive objectness at 2 and the negative at 0,
  so each live class scores about 1/9 x 0.88 (the split activation) and
  the RoI NMS again sees its full 2000;
- DetectoRS's SAC (its kernels are flax params named ``weight`` and
  ``weight_diff``): ``weight`` as any kernel, ``weight_diff``, the context
  1x1s (``pre_context``, ``post_context``) and the RFP's ``rfp_conv``
  small (0.1 of a kernel's scale), so a SAC block keeps its input's
  scale as a plain conv does, through both backbones;
- HRNet's fuse convs (``fuse{i}_{j}_conv``, ``fuse{i}_{j}_ds{k}_conv``)
  small too: each fused branch is a sum over every branch, and at the
  plain scale seven modules of such sums lift HRNet-W32's branches to
  3e4 (to about 700 with them), where the RoI head's logits are the
  features' noise, not its biases, and its NMS sees half its 2000
  candidates; grouped and depthwise kernels (RegNet, ResNeSt, MobileNetV2)
  and ResNeSt's split-attention FCs take the plain fill, their fan-in
  being the group's (a flax kernel's (kh, kw, in / groups) axes) or the
  Dense kernel's input;
- a deformable conv's kernel, a flax leaf named ``X_kernel`` (the
  backbones' ``conv2_kernel``, the towers' last conv's, VFNet's star
  convs'), as any kernel; its offset conv (``X_offset``) too, so the
  seeded offsets are of order one pixel;
- SSD's per-level classifiers (``cls_conv{l}``, A x (C + 1) channels, the
  background last in each anchor's block) as the RoI head's, so each
  anchor's softmax puts about 1/9 on each live class, above SSD's
  ``score_thr`` 0.02; its regressors (``reg_conv{l}``) small, so boxes stay
  near their anchors.
"""

from __future__ import annotations

import numpy as np


LIVE_CLASSES = 8


def fill_variables(shapes: dict, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    head = shapes.get("params", {}).get("bbox_head", {})
    # RetinaNet's anchors per position: its regressor has 4 outputs each
    retina_anchors = (head["retina_reg"]["bias"].shape[0] // 4
                      if "retina_reg" in head else 1)
    # SSD's head: per-level predictors and no tower (FCOS's and RetinaNet's
    # cls_conv{i} are towers beside their conv_cls / retina_cls)
    ssd = ("cls_conv0" in head and "conv_cls" not in head
           and "retina_cls" not in head)

    def seesaw(path, shape):
        # SeesawLoss's C + 2 logits beside a class-specific regressor's 4C
        parent = shapes["params"]
        for key in path[1:-2]:
            parent = parent[key]
        reg = parent.get("fc_reg", {}).get("bias")
        return reg is not None and reg.shape[0] == 4 * (shape[0] - 2)

    def ssd_pred(path):
        return (ssd and len(path) >= 3 and path[-3] == "bbox_head"
                and path[-2][:8] in ("cls_conv", "reg_conv"))

    def fill(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if ssd_pred(path) and path[-2].startswith("cls") and name == "bias":
            anchors = head[path[-2].replace("cls", "reg")]["bias"].shape[0] // 4
            per_anchor = shape[0] // anchors            # C + 1
            classes = np.arange(shape[0]) % per_anchor
            background = per_anchor - 1
            v = np.where(classes < LIVE_CLASSES, rng.uniform(1.0, 2.0, shape),
                         np.where(classes == background, 0.0, -8.0))
        elif ssd_pred(path) and name == "kernel":
            gain = 0.02 if path[-2].startswith("cls") else 0.1
            v = rng.randn(*shape) * gain / np.sqrt(np.prod(shape[:-1]))
        elif ssd_pred(path) and name == "bias":
            v = 0.05 * rng.randn(*shape)
        elif path[-2:] == ("conv_cls", "kernel"):
            v = rng.randn(*shape) * 0.02 / np.sqrt(np.prod(shape[:-1]))
        elif path[-2:] == ("conv_cls", "bias"):
            live = np.arange(shape[0]) < LIVE_CLASSES
            v = np.where(live, rng.uniform(-1.5, 1.0, shape), -8.0)
        elif path[-2:] == ("conv_reg", "kernel"):
            v = rng.randn(*shape) * 0.3 / np.sqrt(np.prod(shape[:-1]))
        elif path[-2:] == ("conv_reg", "bias"):
            v = rng.uniform(1.5, 3.0, shape)
        elif path[-2:] == ("retina_cls", "bias"):
            live = np.arange(shape[0]) % (shape[0] // retina_anchors) < LIVE_CLASSES
            v = np.where(live, rng.uniform(-1.5, 1.0, shape), -8.0)
        elif path[-2:] == ("fc_cls", "bias") and seesaw(path, shape):
            classes = np.arange(shape[0])
            v = np.where(classes < LIVE_CLASSES, rng.uniform(1.0, 2.0, shape),
                         np.where(classes == shape[0] - 2, 2.0,
                                  np.where(classes == shape[0] - 1, 0.0,
                                           -8.0)))
        elif path[-2:] == ("fc_cls", "bias"):
            classes = np.arange(shape[0])
            v = np.where(classes < LIVE_CLASSES, rng.uniform(1.0, 2.0, shape),
                         np.where(classes == shape[0] - 1, 0.0, -8.0))
        elif path[-1] == "kernel" and path[-2] in ("retina_cls", "fc_cls"):
            v = rng.randn(*shape) * 0.02 / np.sqrt(np.prod(shape[:-1]))
        elif path[-1] == "kernel" and path[-2] in ("retina_reg", "rpn_reg",
                                                   "fc_reg"):
            v = rng.randn(*shape) * 0.1 / np.sqrt(np.prod(shape[:-1]))
        elif path[-1] == "bias" and path[-2] in ("retina_reg", "rpn_reg",
                                                 "fc_reg"):
            v = 0.05 * rng.randn(*shape)
        elif name == "weight_diff" or (
                name == "kernel" and (path[-2] in ("pre_context",
                                                   "post_context", "rfp_conv")
                                      or path[-2].startswith("fuse"))):
            v = rng.randn(*shape) * 0.1 / np.sqrt(np.prod(shape[:-1]))
        elif (name == "kernel" or (name == "weight" and len(shape) == 4)
              or (name.endswith("_kernel") and len(shape) == 4)):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = rng.randn(*shape) * 0.1
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    def walk(tree, prefix=()):
        return {k: walk(v, prefix + (k,)) if hasattr(v, "items")
                else fill(prefix + (k,), v) for k, v in tree.items()}

    return walk(shapes)
