"""Shared inputs for the torch-port parity tests (``test_torch_port_*.py``).

The JAX flagship and the port are built from the same config dict (the one
``__graft_entry__._flagship_detector`` builds); variables come from
``jax.eval_shape`` plus the port's seeded numpy fill (no flax init forward),
and reach the port through the weight bridge. The semi loop's helpers at
the end (label-file comparison) are read by ``chip_smoke.py`` too, so this
module imports JAX only inside the functions that build the JAX side.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path

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


_SHAPES: dict = {}
_JAX_MASK_TARGETS: dict = {}


def jax_detector_and_variables(cfg: dict, seed: int = 0, hw=(64, 96)):
    """The JAX detector of ``cfg`` and its variables filled from ``seed``;
    the variables' shapes traced once per config and input size."""
    import jax
    import jax.numpy as jnp

    from dsl_tpu.models import build_detector

    det = build_detector(copy.deepcopy(cfg))
    key = (repr(cfg), tuple(hw))
    if key not in _SHAPES:
        _SHAPES[key] = _plain(jax.eval_shape(
            det.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float32)))
    return det, fill_variables(_SHAPES[key], seed)


def jax_run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled without LLVM's expensive passes:
    the same values on the backbones of ``test_torch_port_hrnet.py`` and
    ``test_torch_port_backbones.py`` at about half the compile time."""
    import jax

    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_llvm_disable_expensive_passes": True})(*args)


def jax_mask_targets(crops, gt_bboxes, rois, batch_idx, assigned_gt,
                     mask_size: int) -> torch.Tensor:
    """JAX's ``mask_targets_from_crops`` on the port's tensors, under one
    ``jax.jit`` per mask size shared by the files that hand JAX's targets
    to the port's mask loss (eager, each call compiles its ops anew)."""
    import jax
    import jax.numpy as jnp

    from dsl_tpu.models.roi_heads import mask_head

    if mask_size not in _JAX_MASK_TARGETS:
        _JAX_MASK_TARGETS[mask_size] = jax.jit(
            lambda *a: mask_head.mask_targets_from_crops(*a,
                                                         mask_size=mask_size))
    out = _JAX_MASK_TARGETS[mask_size](*(
        jnp.asarray(a.numpy()) for a in (crops, gt_bboxes, rois, batch_idx,
                                         assigned_gt)))
    return torch.from_numpy(np.array(out))


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


# the flagship's schedule (configs/_base_/schedules/schedule_semi.py) and EMA
OPTIMIZER = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4,
                 paramwise_cfg=dict(bias_lr_mult=2.0, bias_decay_mult=0.0))
OPTIMIZER_CONFIG = dict(grad_clip=dict(max_norm=35, norm_type=2))
LR_CONFIG = dict(policy="step", warmup="linear", warmup_iters=500,
                 warmup_ratio=1.0 / 3, step=[20, 26])
STEPS_PER_EPOCH = 1000


def semi_batch(seed: int = 1):
    """A tiny semi batch at 64x96: a labeled image with GT, a labeled one
    with none, an unlabeled one with GT and two ignore boxes, and the
    unlabeled image's half-res copy (the si pair)."""
    from dsl_tpu_torch.utils.random_batch import semi_batch as make

    return make(seed, (64, 96), n_gt=[3, 0, 5], n_ignore=[0, 0, 2],
                n_labeled=2, k=8, ki=4, side=(4, 40))


def jax_batch(batch: dict) -> dict:
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, batch)


def frozen_tree(port) -> dict:
    """The port's frozen parameters (requires_grad False) as a flax-layout
    bool tree."""
    from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax

    flags = {n: torch.full_like(p, float(not p.requires_grad))
             for n, p in port.named_parameters()}
    return _as_bool(state_dict_to_flax(flags)["params"])


def _as_bool(tree):
    if isinstance(tree, dict):
        return {k: _as_bool(v) for k, v in tree.items()}
    return bool(np.asarray(tree).all())


def assert_banded(got: dict, want: dict, init: dict | None = None,
                  rel: float = 0.05, floor: float = 1e-5, l2: float = 1e-3,
                  skip: dict | None = None):
    """Per-leaf |got - want| <= max(rel * scale, floor), scale the larger of
    the two's largest |delta| from ``init`` (zeros without one), and the
    concatenated deltas within ``l2`` relative L2 error; leaves marked in
    ``skip`` are left out. Returns the number of leaves compared."""
    import jax

    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_i = dict(jax.tree_util.tree_flatten_with_path(init)[0]) if init else {}
    flat_s = dict(jax.tree_util.tree_flatten_with_path(skip)[0]) if skip else {}
    d_got, d_want, n = [], [], 0
    for path, w in flat_w:
        if flat_s.get(path, False):
            continue
        base = np.asarray(flat_i[path]) if init else 0.0
        dw = (np.asarray(w) - base).ravel()
        dg = (np.asarray(flat_g[path]) - base).ravel()
        scale = float(max(np.abs(dw).max(), np.abs(dg).max()))
        err = float(np.abs(dg - dw).max())
        assert err <= max(rel * scale, floor), (
            f"{jax.tree_util.keystr(path)}: err {err:.3e}, scale {scale:.3e}")
        d_got.append(dg)
        d_want.append(dw)
        n += 1
    d_got, d_want = np.concatenate(d_got), np.concatenate(d_want)
    rel_l2 = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
    assert rel_l2 < l2, f"aggregate relative L2 error {rel_l2:.3e}"
    return n


# -- the semi loop (also read by chip_smoke.py) -----------------------------

def tree_of(path) -> dict[str, bytes]:
    """File name -> bytes of every file in a directory."""
    return {name: (Path(path) / name).read_bytes()
            for name in sorted(os.listdir(path))}


# the flagship's strong augmentations
STRONG_AUGMENTATIONS = ("PatchShuffle", "RandomAugmentBBox_Fast", "UBAug")


def cut_flagship(cfg: dict, max_epochs: int, start_point: int) -> dict:
    """A copy of the flagship config without the strong augmentations and
    ``evaluation``, ``max_epochs`` epochs, the refresh from epoch
    ``start_point``: the semi tests' config, whose JAX side (the ``slow``
    run of both packages' ``train_detector``) would otherwise also compile
    its evaluation."""
    cfg = copy.deepcopy(cfg)
    for key in ("train", "unlabel_train"):
        cfg["data"][key]["pipeline"] = [
            t for t in cfg["data"][key]["pipeline"]
            if t["type"] not in STRONG_AUGMENTATIONS]
    cfg.pop("evaluation", None)
    cfg["runner"]["max_epochs"] = max_epochs
    cfg["data"]["unlabel_pred"]["start_point"] = start_point
    return cfg


def pair_labels(got: dict, want: dict, px: float = 1.0,
                score: float = 1e-3) -> tuple[int, float]:
    """Pair the boxes of one label file with another's: each box of ``got``
    with an unused box of ``want`` of the same tag within ``px`` on every
    side and ``score`` in score (a pairing, not an order: near-equal scores
    may come in either order). Returns (boxes of either file left
    unpaired, the largest difference of a pair)."""
    free = list(range(want["targetNum"]))
    worst, unpaired = 0.0, 0
    for tag, rect, s in zip(got["tags"], got["rects"], got["scores"]):
        for j in free:
            d = max(abs(u - v) for u, v in zip(rect, want["rects"][j]))
            if want["tags"][j] == tag and d <= px and abs(
                    s - want["scores"][j]) <= score:
                free.remove(j)
                worst = max(worst, d)
                break
        else:
            unpaired += 1
    return unpaired + len(free), worst


# -- JPEG files with an EXIF orientation, and unreadable ones ------------------

def exif_segment(orientation: int, order: str = "II", value_type: int = 3,
                 tiff_magic: bytes | None = None, n_entries: int = 1) -> bytes:
    """An APP1 segment holding ``Exif\\0\\0`` and a TIFF IFD0 with one
    Orientation (0x0112) entry of ``value_type`` (3: SHORT), in little
    (``II``) or big (``MM``) endian. ``tiff_magic`` replaces the TIFF
    header's first 4 bytes; ``n_entries`` is the entry count IFD0 claims."""
    import struct

    e = "<" if order == "II" else ">"
    head = tiff_magic or (b"II*\x00" if order == "II" else b"MM\x00*")
    value = (struct.pack(e + "H", orientation) + b"\x00\x00" if value_type == 3
             else struct.pack(e + "I", orientation))
    ifd = (struct.pack(e + "H", n_entries)
           + struct.pack(e + "HHI", 0x0112, value_type, 1) + value
           + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + head + struct.pack(e + "I", 8) + ifd
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(data: bytes, segment: bytes) -> bytes:
    """A JPEG's bytes with ``segment`` inserted right after its SOI."""
    return data[:2] + segment + data[2:]


def orient_like_cv2(img: np.ndarray, orientation: int) -> np.ndarray:
    """What ``cv2.imread`` returns for a file decoded as ``img`` that
    carries ``orientation``: numpy flips and transposes."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flips = {1: (), 2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1),
             8: (0,)}[orientation]
    return np.ascontiguousarray(np.flip(img, flips) if flips else img)


def unreadable_files(root: Path, source: bytes) -> dict[str, Path]:
    """Files ``cv2.imread`` gives no image for, written into ``root`` (and
    one name that is not there): empty, cut inside the header (its first
    600 bytes), SOI followed by seeded bytes that hold no 0xFF."""
    rng = np.random.RandomState(0)
    files = {"empty": b"", "header_cut": source[:600],
             "garbage": b"\xff\xd8\xff" + rng.randint(0, 255, 4000).astype(
                 np.uint8).tobytes()}
    out = {}
    for name, data in files.items():
        out[name] = root / f"{name}.jpg"
        out[name].write_bytes(data)
    out["missing"] = root / "missing.jpg"
    return out


# DSL's supervised baseline (configs/fcos_semi/r50_caffe_mslonger_tricks_0.
# Xdata.py): a caffe-style ResNet-50, here with 16 stem and base channels
# (stages of 64-512) under an FPN and head as narrow as the tiny flagship's
TINY_BASELINE_CFG = copy.deepcopy(TINY_CFG)
TINY_BASELINE_CFG["backbone"] = dict(
    type="ResNet", depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
    frozen_stages=1, norm_eval=True, style="caffe", stem_channels=16,
    base_channels=16)
TINY_BASELINE_CFG["neck"]["in_channels"] = [64, 128, 256, 512]
TINY_BASELINE_CFG["bbox_head"].update(loss_weight=1.0, soft_weight=0.0,
                                      soft_warm_up=0)


def png_bytes(h: int, w: int) -> bytes:
    """A valid (h, w) black RGB PNG, written with the standard library (the
    card's machine has no image library)."""
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = b"".join(b"\x00" + bytes(3 * w) for _ in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def usable_boxes(rects, h: int, w: int) -> list:
    """The boxes of a label file a dataset keeps (``SemiCOCODataset``, as
    the JAX package): at least 1 px on each side, overlapping the image."""
    return [r for r in rects if r[2] - r[0] >= 1 and r[3] - r[1] >= 1
            and min(r[2], w) > max(r[0], 0) and min(r[3], h) > max(r[1], 0)]
