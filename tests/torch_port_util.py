"""Shared inputs for the torch-port parity tests (``test_torch_port_*.py``).

The JAX flagship and the port are built from the same config dict (the one
``__graft_entry__._flagship_detector`` builds); variables come from
``jax.eval_shape`` plus the port's seeded numpy fill (no flax init forward),
and reach the port through the weight bridge.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from dsl_tpu_torch.utils.random_weights import fill_variables

TINY_CFG = dict(
    type="FCOS",
    backbone=dict(type="RLA_ResNet", layers=[1, 1, 1, 1], frozen_stages=1),
    neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048], out_channels=64,
              start_level=1, add_extra_convs="on_output", num_outs=5,
              relu_before_extra_convs=True),
    bbox_head=dict(type="FCOSHead", num_classes=80, in_channels=64,
                   stacked_convs=1, feat_channels=64,
                   strides=[8, 16, 32, 64, 128], norm_on_bbox=True,
                   centerness_on_reg=True, center_sampling=True,
                   conv_bias=True, loss_weight=3.0, soft_weight=1.0,
                   soft_warm_up=5000),
    test_cfg=dict(nms_pre=1000, score_thr=0.05,
                  nms=dict(type="nms", iou_threshold=0.6), max_per_img=100))


def full_cfg() -> dict:
    """The flagship at full width (RLA-R50 [3,4,6,3], FPN 256, 4-conv towers)."""
    cfg = copy.deepcopy(TINY_CFG)
    cfg["backbone"]["layers"] = [3, 4, 6, 3]
    cfg["neck"]["out_channels"] = 256
    cfg["bbox_head"].update(in_channels=256, feat_channels=256,
                            stacked_convs=4)
    return cfg


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def jax_detector_and_variables(cfg: dict, seed: int = 0, hw=(64, 96)):
    import jax
    import jax.numpy as jnp

    from dsl_tpu.models import build_detector

    det = build_detector(copy.deepcopy(cfg))
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3), jnp.float32))
    return det, fill_variables(_plain(shapes), seed)


def port_detector(cfg: dict, variables: dict):
    from dsl_tpu_torch.models import build_detector
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict

    det = build_detector(copy.deepcopy(cfg))
    det.load_state_dict(flax_to_state_dict(variables))
    return det.eval()


def images(seed: int, b: int, hw) -> np.ndarray:
    """NHWC f32 images, roughly normalized."""
    return np.random.RandomState(seed).randn(b, *hw, 3).astype(np.float32)


def nchw(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
