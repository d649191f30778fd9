"""The weight bridge for the variants' layouts, and the configs they unlock.

- the weight bridge both ways, flax tree to the port's state_dict and
  back, for every new layout: grouped kernels (JAX's (kh, kw, Cin/g, Cout)
  to torch's (Cout, Cin/g, kh, kw)), ConvWS kernels, GroupNorm in the FPN
  and the RoI head, ``Shared4Conv1FCBBoxHead``'s convs and its FC rows
  (read (c, h, w) after its convs), V1d's deep stem, the standalone RPN,
  Fast R-CNN's RoI head, SSD's head and neck with the L2Norm's ``weight``;
- every config this slice unlocks builds on the meta device, with the JAX
  package's parameter counts (``jax.eval_shape`` of
  ``init_detector_variables``) where stated.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.models import build_detector as j_build
from dsl_tpu.models.detectors.single_stage import init_detector_variables
from dsl_tpu_torch.models import build_detector
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.random_weights import fill_variables
from dsl_tpu_torch.utils.synthetic_data import (
    TINY_FAST_RCNN, TINY_FASTER_RCNN, TINY_GN_WS_RCNN, TINY_RESNEXT_RCNN,
    TINY_RPN, TINY_SSD)

torch.set_num_threads(2)

V1D = dict(type="ResNetV1d", depth=18, stem_channels=32, frozen_stages=1)


def detector_pair(cfg: dict, hw):
    det = j_build(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda r, x: init_detector_variables(det, r, x),
                            jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    var = {k: U._plain(v) for k, v in fill_variables(
        U._plain(dict(shapes)), 0).items()}
    port = build_detector(copy.deepcopy(cfg))
    port.load_state_dict(flax_to_state_dict(var))
    return var, port


@pytest.mark.parametrize("cfg", [
    TINY_RESNEXT_RCNN, TINY_GN_WS_RCNN, dict(TINY_FASTER_RCNN, backbone=V1D),
    pytest.param(TINY_RPN, marks=pytest.mark.slow), TINY_FAST_RCNN, TINY_SSD],
    ids=["resnext", "gn_ws", "v1d", "rpn", "fast_rcnn", "ssd"])
def test_bridge_round_trip_variants(cfg):
    var, port = detector_pair(cfg, (128, 128) if cfg is TINY_SSD else (64, 96))
    sd = port.state_dict()
    back = state_dict_to_flax(sd)
    for col in ("params", "batch_stats"):
        assert sorted(back[col]) == sorted(var.get(col, {}))
        for path, leaf in jax.tree_util.tree_leaves_with_path(var.get(col, {})):
            got = back[col]
            for p in path:
                got = got[p.key]
            np.testing.assert_array_equal(got, np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))
    assert not any(k.startswith("bbox_head.shared") for k in sd)


# configs this slice unlocks (the sweep in ROADMAP §1): each builds on the
# meta device; the counts are the JAX package's (jax.eval_shape of
# init_detector_variables)
UNLOCKED = {
    "pascal_voc/ssd300_voc0712.py": ("SSD", 26285486),
    "pascal_voc/ssd512_voc0712.py": ("SSD", 27188676),
    "ssd/ssd300_coco.py": ("SSD", None),
    "ssd/ssd512_coco.py": ("SSD", None),
    "legacy_1.x/ssd300_coco_v1.py": ("SSD", 34305206),
    "wider_face/ssd300_wider_face.py": ("SSD", 23745908),
    "faster_rcnn/faster_rcnn_x101_64x4d_fpn_1x_coco.py": ("FasterRCNN", 99651296),
    "faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py": ("FasterRCNN", None),
    "gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py": ("FasterRCNN", 43064800),
    "gn+ws/faster_rcnn_x101_32x4d_fpn_gn_ws-all_1x_coco.py": ("FasterRCNN", None),
    "faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py": ("FasterRCNN", 41753056),
    "faster_rcnn/faster_rcnn_r50_fpn_iou_1x_coco.py": ("FasterRCNN", None),
    "faster_rcnn/faster_rcnn_r50_fpn_bounded_iou_1x_coco.py": ("FasterRCNN", None),
    "faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py": ("FasterRCNN", 165511648),
    "rpn/rpn_r50_fpn_1x_coco.py": ("RPN", 27446351),
    "rpn/rpn_x101_64x4d_fpn_1x_coco.py": ("RPN", None),
    "rpn/rpn_r50_caffe_c4_1x_coco.py": ("RPN", None),
    "fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py": ("FastRCNN", 41159121),
    "fast_rcnn/fast_rcnn_r101_caffe_fpn_1x_coco.py": ("FastRCNN", None),
    "retinanet/retinanet_x101_64x4d_fpn_1x_coco.py": ("RetinaNet", None),
    "legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py": ("RetinaNet", 37968692),
}


@pytest.mark.parametrize("config", sorted(UNLOCKED))
def test_the_unlocked_configs_build(config):
    from dsl_tpu_torch.config import Config

    kind, params = UNLOCKED[config]
    with torch.device("meta"):
        det = build_detector(dict(Config.fromfile(f"configs/{config}").model))
    assert type(det).__name__ == kind
    if params is not None:
        assert sum(p.numel() for p in det.parameters()) == params
