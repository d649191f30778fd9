"""Synthetic semicoco and VOC directories, for smoke runs and parity tests
(no dataset ships with the repo).

:func:`make_semicoco_dir` lays out what ``tools/coco_convert2_semicoco_json.py``
makes from COCO, from a few JPEG files copied under new names:

  images/full/<name>.jpg
  labeled.json, unlabeled.json        COCO image lists (80 COCO categories)
  prepared_annos/<name>.jpg.json      per-image GT of the labeled images
  unlabel_prepared_annos/<name>.jpg.json
                                      initial labels of the unlabeled ones
  mmdet_category_info.json            cat2id / id2cat, background last
  valid_images/full/<name>.jpg, val.json
                                      with ``n_val``: a val set, its GT
                                      in the COCO file

Each label file holds 1-5 seeded boxes with COCO tags and no scores
(``imageName/targetNum/rects/tags/masks``), as the converter writes them;
each val image 1-5 seeded COCO annotations.
:func:`semi_config` points a config's ``data`` block at such a directory.

:func:`make_voc_dir` lays out a PASCAL VOC2007 directory (``JPEGImages/``,
``Annotations/<id>.xml`` with ``<size>``, ``difficult`` flags and names
outside the 20 classes, ``ImageSets/Main/{trainval,test}.txt``);
``tools/voc_convert2_semivoc_json.py`` turns its trainval split into the
labeled store DSL's VOC config reads (``images/full``,
``prepared_annos/Industry/...``, ``mmdet_category_info.json``), and
:func:`make_semivoc_unlabeled` adds the unlabeled split beside it.
:func:`voc_semi_config` points the VOC config's ``data`` block there.

``TINY_FASTER_RCNN`` and ``TINY_RETINANET`` are the anchor-based detectors
of ``configs/pascal_voc/`` cut to a size the CPU tests run in seconds
(ResNet-18, FPN and heads 32 wide, 20 VOC classes; the inputs 64x96);
``TINY_RPN`` and ``TINY_FAST_RCNN`` its two halves (the RPN with the
standalone configs' ``allowed_border`` 0), ``TINY_RESNEXT_RCNN`` and
``TINY_GN_WS_RCNN`` its ResNeXt and gn+ws variants, ``TINY_SSD`` SSD's
neck, head, anchor ladder and loss on a ResNet-18 (SSD's VGG-16 has no
narrow form; the inputs 128x128);
:func:`voc_detector_config` points one of those VOC configs (whose data
blocks name no pipeline) at a :func:`make_voc_dir` directory with the
config's own train and test pipelines. ``TINY_MASK_RCNN`` is
``TINY_FASTER_RCNN`` with a 2-conv, 32-channel ``FCNMaskHead``;
``TINY_MASK_SCORING_RCNN`` adds a 32-channel ``MaskIoUHead``;
``TINY_CASCADE_RCNN`` has ``TINY_FASTER_RCNN``'s parts with three bbox
heads at the cascade's stds, ``TINY_CASCADE_MASK_RCNN`` also
``TINY_MASK_RCNN``'s mask head. ``TINY_HTC`` is ``TINY_CASCADE_RCNN`` with
three 2-conv, 32-channel ``HTCMaskHead``s (the first without
``conv_res``) and a 1-conv, 32-channel ``FusedSemanticHead`` of 24
classes; ``TINY_SCNET`` has three 32-wide ``SCNetBBoxHead``s, a
one-block ``SCNetMaskHead``, the same semantic head, a one-block
``GlobalContextHead`` and a 64-to-32 ``FeatureRelayHead``;
``TINY_DETECTORS_FASTER`` is DetectoRS on ``TINY_FASTER_RCNN``'s RPN and
RoI head, whose backbones keep depth 50 (the only depths, and widths,
the JAX package's DetectoRS has), the RFP neck 32 wide.
``TINY_POINT_REND`` is ``TINY_MASK_RCNN`` with a 64-wide ``CoarseMaskHead``
(7x7 logits) and a 32-wide 3-FC ``MaskPointHead`` (two subdivision steps
of 196 points); ``TINY_YOLACT`` is YOLACT on the ResNet-18 (nothing
frozen), the bilinear FPN, a 32-wide head of 8 prototypes and the
protonet at 32; ``TINY_SEESAW`` is ``TINY_MASK_RCNN`` with ``SeesawLoss``
and the normed mask predictor (the Seesaw configs' parts).

:func:`make_coco_instance_dir` writes a COCO instance set (``train.json``,
``val.json`` and the images beside them) whose annotations carry every
``segmentation`` form: polygons (one or two per instance), uncompressed
RLE, an ``iscrowd`` RLE, and, in the train split, none at all;
:func:`coco_instance_config` points a COCO config's ``data`` block there.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import numpy as np

from dsl_tpu_torch.data.datasets.coco import COCO_CLASSES
from dsl_tpu_torch.data.datasets.voc import VOC_CLASSES

BACKGROUND = "background"


def _boxes(rng: np.random.RandomState, h: int, w: int, n: int) -> list:
    out = []
    for _ in range(n):
        bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        out.append([float(x1), float(y1), float(x1 + bw), float(y1 + bh)])
    return out


def _write_label(path: Path, name: str, rects: list, tags: list):
    data = dict(imageName="full/" + name, targetNum=len(rects), rects=rects,
                tags=tags, masks=[[] for _ in rects])
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4, ensure_ascii=False)


def make_semicoco_dir(root, sources: list[tuple[str, int, int]],
                      n_labeled: int, n_unlabeled: int, seed: int = 0,
                      n_val: int = 0) -> dict:
    """``sources`` are (image path, height, width); image i of each split
    is a copy of source ``i % len(sources)``, named with the source's
    suffix (``.jpg``, ``.png``). Returns the paths by role."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    img_dir = root / "images" / "full"
    lab_dir = root / "prepared_annos"
    unl_dir = root / "unlabel_prepared_annos"
    for d in (img_dir, lab_dir, unl_dir):
        d.mkdir(parents=True, exist_ok=True)
    cat2id = {c: i for i, c in enumerate(COCO_CLASSES)}
    cat2id[BACKGROUND] = len(COCO_CLASSES)
    info = root / "mmdet_category_info.json"
    with open(info, "w", encoding="utf-8") as f:
        json.dump(dict(cat2id=cat2id,
                       id2cat={str(i): c for c, i in cat2id.items()}),
                  f, indent=4, ensure_ascii=False)
    categories = [dict(id=i + 1, name=c) for i, c in enumerate(COCO_CLASSES)]
    lists = {}
    for split, count, label_dir in (("labeled", n_labeled, lab_dir),
                                    ("unlabeled", n_unlabeled, unl_dir)):
        images = []
        for i in range(count):
            src, h, w = sources[i % len(sources)]
            name = f"{split}_{i:03d}{Path(src).suffix}"
            shutil.copyfile(src, img_dir / name)
            images.append(dict(id=i + 1, file_name=name, width=w, height=h))
            n = rng.randint(1, 6)
            tags = [COCO_CLASSES[k] for k in rng.randint(0, len(COCO_CLASSES), n)]
            _write_label(label_dir / f"{name}.json", name, _boxes(rng, h, w, n),
                         tags)
        lists[split] = root / f"{split}.json"
        with open(lists[split], "w", encoding="utf-8") as f:
            json.dump(dict(images=images, categories=categories,
                           annotations=[]), f)
    paths = dict(root=str(root), images=str(img_dir),
                 labeled=str(lists["labeled"]),
                 unlabeled=str(lists["unlabeled"]), label_store=str(lab_dir),
                 unlabel_store=str(unl_dir), category_info=str(info),
                 adathres=str(root / "adathres.json"))
    if n_val:
        paths.update(_make_val(root, sources, n_val, categories, rng))
    return paths


def _make_val(root: Path, sources, n_val: int, categories: list,
              rng: np.random.RandomState) -> dict:
    """``n_val`` copies of the sources under ``valid_images/full/`` and a
    COCO file with 1-5 seeded annotations each."""
    val_dir = root / "valid_images" / "full"
    val_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i in range(n_val):
        src, h, w = sources[i % len(sources)]
        name = f"val_{i:03d}{Path(src).suffix}"
        shutil.copyfile(src, val_dir / name)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        for x1, y1, x2, y2 in _boxes(rng, h, w, rng.randint(1, 6)):
            annotations.append(dict(
                id=len(annotations) + 1, image_id=i + 1,
                category_id=int(rng.randint(1, len(categories) + 1)),
                bbox=[x1, y1, x2 - x1, y2 - y1], area=(x2 - x1) * (y2 - y1),
                iscrowd=0))
    val = root / "val.json"
    with open(val, "w", encoding="utf-8") as f:
        json.dump(dict(images=images, categories=categories,
                       annotations=annotations), f)
    return dict(val=str(val), val_images=str(val_dir))


def semi_config(cfg: dict, paths: dict) -> dict:
    """A copy of ``cfg`` (a plain dict) whose ``data.train`` and, where the
    config has them (a semi-supervised one), ``data.unlabel_train`` and
    ``data.unlabel_pred`` (and ``data.val`` and ``data.test`` where the
    directory has a val set) read ``paths`` (as :func:`make_semicoco_dir`
    returns them); ``unlabel_train.thres`` becomes the directory's
    ``adathres.json`` where it names a file."""
    cfg = copy.deepcopy(cfg)
    data = cfg["data"]
    common = dict(labelmapper=paths["category_info"], img_prefix=paths["images"])
    data["train"].update(ann_file=paths["labeled"],
                         ann_path=paths["label_store"], **common)
    if "unlabel_train" in data:
        data["unlabel_train"].update(ann_file=paths["unlabeled"],
                                     ann_path=paths["unlabel_store"], **common)
        if isinstance(data["unlabel_train"].get("thres"), str):
            data["unlabel_train"]["thres"] = paths["adathres"]
    if "unlabel_pred" in data:
        data["unlabel_pred"].update(
            image_root_path=paths["images"],
            image_list_file=paths["unlabeled"],
            anno_root_path=paths["unlabel_store"],
            category_info_path=paths["category_info"])
    if "val" in paths:
        for key in ("val", "test"):
            if key in data:
                data[key].update(ann_file=paths["val"],
                                 img_prefix=paths["val_images"])
    return cfg


VOC_DATA_ROOT = "data/semivoc/"   # the VOC config's data_root
VOC_UNLISTED = "unicorn"          # an object name outside VOC_CLASSES


def _voc_xml(img_id: str, h: int, w: int, objects: list) -> str:
    objs = "".join(
        f"<object><name>{name}</name><pose>Unspecified</pose>"
        f"<truncated>0</truncated><difficult>{difficult}</difficult>"
        f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
        f"<ymax>{y2}</ymax></bndbox></object>"
        for name, difficult, (x1, y1, x2, y2) in objects)
    return (f"<annotation><folder>VOC2007</folder><filename>{img_id}.jpg"
            f"</filename><size><width>{w}</width><height>{h}</height>"
            f"<depth>3</depth></size><segmented>0</segmented>{objs}"
            f"</annotation>")


def make_voc_dir(root, sources: list[tuple[str, int, int]], n_trainval: int,
                 n_test: int, seed: int = 0) -> dict:
    """A VOC2007 directory ``root/VOC2007`` of ``n_trainval + n_test``
    copies of ``sources`` ((jpeg path, height, width), image i a copy of
    source ``i % len(sources)``), ids ``000000`` on: each XML has the
    image's ``<size>`` and 1-5 seeded objects of VOC classes, a fifth of
    them ``difficult``, and now and then one named ``VOC_UNLISTED``. The
    first ``n_trainval`` ids are the trainval split, the rest the test
    split. Returns the paths by role."""
    voc = Path(root) / "VOC2007"
    rng = np.random.RandomState(seed)
    dirs = {k: voc / k for k in ("JPEGImages", "Annotations", "ImageSets/Main")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    ids = [f"{i:06d}" for i in range(n_trainval + n_test)]
    for i, img_id in enumerate(ids):
        src, h, w = sources[i % len(sources)]
        shutil.copyfile(src, dirs["JPEGImages"] / f"{img_id}.jpg")
        n = rng.randint(1, 6)
        objects = [(VOC_CLASSES[rng.randint(len(VOC_CLASSES))],
                    int(rng.rand() < 0.2), [int(v) for v in box])
                   for box in _boxes(rng, h, w, n)]
        if rng.rand() < 0.3:
            objects.append((VOC_UNLISTED, 0, [int(v) for v in
                                              _boxes(rng, h, w, 1)[0]]))
        (dirs["Annotations"] / f"{img_id}.xml").write_text(
            _voc_xml(img_id, h, w, objects))
    splits = {}
    for split, part in (("trainval", ids[:n_trainval]), ("test", ids[n_trainval:])):
        splits[split] = dirs["ImageSets/Main"] / f"{split}.txt"
        splits[split].write_text("\n".join(part) + "\n")
    return dict(voc_root=str(voc), images=str(dirs["JPEGImages"]),
                trainval=str(splits["trainval"]), test=str(splits["test"]))


def make_semivoc_unlabeled(root, sources: list[tuple[str, int, int]],
                           n_unlabeled: int, seed: int = 0,
                           initial_labels: bool = True) -> dict:
    """The unlabeled split of DSL's VOC layout under ``root``, beside what
    ``tools/voc_convert2_semivoc_json.py --output root`` writes:
    ``unlabel_images/full/`` (copies of ``sources``), its list
    ``unlabel_prepared_annos/Industry/train_list.txt`` and a label file per
    image under ``.../annotations/full/``, with 1-5 seeded VOC boxes and no
    scores (``initial_labels``) or none (what a bootstrap that found
    nothing writes). Returns the paths of both splits by role, as
    :func:`voc_semi_config` reads them."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    img_dir = root / "unlabel_images" / "full"
    ann_dir = root / "unlabel_prepared_annos" / "Industry" / "annotations" / "full"
    for d in (img_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(n_unlabeled):
        src, h, w = sources[i % len(sources)]
        name = f"unlabeled_{i:03d}.jpg"
        shutil.copyfile(src, img_dir / name)
        rects, tags = [], []
        if initial_labels:
            n = rng.randint(1, 6)
            rects = _boxes(rng, h, w, n)
            tags = [VOC_CLASSES[k] for k in rng.randint(0, len(VOC_CLASSES), n)]
        _write_label(ann_dir / f"{name}.json", name, rects, tags)
        names.append(name)
    unlabeled = ann_dir.parent.parent / "train_list.txt"
    unlabeled.write_text("\n".join(names) + "\n")
    labeled = root / "prepared_annos" / "Industry"
    return dict(root=str(root), images=str(root / "images" / "full"),
                labeled=str(labeled / "train_list.txt"),
                label_store=str(labeled / "annotations" / "full"),
                unlabel_images=str(img_dir), unlabeled=str(unlabeled),
                unlabel_store=str(ann_dir),
                category_info=str(root / "mmdet_category_info.json"),
                adathres=str(root / "adathres.json"),
                val=str(root / "VOC2007" / "ImageSets" / "Main" / "test.txt"),
                val_images=str(root / "VOC2007"))


def voc_semi_config(cfg: dict, paths: dict) -> dict:
    """A copy of the VOC config ``cfg`` (a plain dict) whose ``data`` paths
    name ``paths`` (as :func:`make_semivoc_unlabeled` returns them): every
    path under the config's ``data_root`` moves under ``paths["root"]``,
    and ``unlabel_train.thres`` becomes the directory's ``adathres.json``.
    The config's ``val`` and
    ``test`` blocks replace their base's (``_delete_``) and name no
    pipeline, so neither package can build them as written: they get the
    config's own ``test_pipeline``."""
    cfg = copy.deepcopy(cfg)
    root = paths["root"].rstrip("/") + "/"

    def moved(node):
        if isinstance(node, dict):
            return {k: moved(v) for k, v in node.items()}
        if isinstance(node, list):
            return [moved(v) for v in node]
        if isinstance(node, str) and node.startswith(VOC_DATA_ROOT):
            return root + node[len(VOC_DATA_ROOT):]
        return node

    data = cfg["data"] = moved(cfg["data"])
    data["unlabel_train"]["thres"] = paths["adathres"]
    for key in ("val", "test"):
        data[key].setdefault("pipeline", copy.deepcopy(cfg["test_pipeline"]))
    return cfg


_TINY_BACKBONE = dict(type="ResNet", depth=18, out_indices=(0, 1, 2, 3),
                      frozen_stages=1, style="pytorch")
_TINY_TEST_CFG = dict(rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=100))
TINY_FASTER_RCNN = dict(
    type="FasterRCNN", backbone=_TINY_BACKBONE,
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=0, num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=32, feat_channels=32,
                  strides=[4, 8, 16, 32, 64]),
    bbox_head=dict(type="Shared2FCBBoxHead", num_classes=20, in_channels=32,
                   roi_size=7, fc_channels=64),
    test_cfg=_TINY_TEST_CFG)
TINY_RETINANET = dict(
    type="RetinaNet", backbone=_TINY_BACKBONE,
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(type="RetinaHead", num_classes=20, in_channels=32,
                   feat_channels=32, stacked_convs=2,
                   strides=[8, 16, 32, 64, 128]),
    test_cfg=dict(nms_pre=1000, score_thr=0.05,
                  nms=dict(type="nms", iou_threshold=0.5), max_per_img=100))


TINY_RPN = dict(
    TINY_FASTER_RCNN, type="RPN", bbox_head=None,
    train_cfg=dict(rpn=dict(allowed_border=0)))
TINY_FAST_RCNN = dict(TINY_FASTER_RCNN, type="FastRCNN", rpn_head=None)
TINY_RESNEXT_RCNN = dict(
    TINY_FASTER_RCNN,
    backbone=dict(type="ResNeXt", depth=50, groups=4, base_width=4,
                  stem_channels=16, base_channels=16, frozen_stages=1),
    neck=dict(TINY_FASTER_RCNN["neck"], in_channels=[64, 128, 256, 512]))
_WS, _GN = dict(type="ConvWS"), dict(type="GN", num_groups=8)
TINY_GN_WS_RCNN = dict(
    TINY_FASTER_RCNN,
    backbone=dict(_TINY_BACKBONE, conv_cfg=_WS, norm_cfg=_GN),
    neck=dict(TINY_FASTER_RCNN["neck"], conv_cfg=_WS, norm_cfg=_GN),
    bbox_head=dict(type="Shared4Conv1FCBBoxHead", num_classes=20,
                   in_channels=32, roi_size=7, conv_out_channels=32,
                   fc_channels=64, conv_cfg=_WS, norm_cfg=_GN))
TINY_MASK_RCNN = dict(
    TINY_FASTER_RCNN, type="MaskRCNN",
    mask_head=dict(type="FCNMaskHead", num_classes=20, in_channels=32,
                   conv_out_channels=32, num_convs=2, roi_size=14),
    test_cfg=dict(rcnn=dict(_TINY_TEST_CFG["rcnn"], mask_thr_binary=0.5)))
TINY_MASK_SCORING_RCNN = dict(
    TINY_MASK_RCNN, type="MaskScoringRCNN",
    mask_iou_head=dict(type="MaskIoUHead", num_classes=20, in_channels=32,
                       conv_out_channels=32, num_convs=4, fc_out_channels=64))
TINY_CASCADE_RCNN = dict(
    {k: v for k, v in TINY_FASTER_RCNN.items() if k != "bbox_head"},
    type="CascadeRCNN",
    bbox_heads=[dict(TINY_FASTER_RCNN["bbox_head"], target_stds=stds)
                for stds in ([0.1, 0.1, 0.2, 0.2], [0.05, 0.05, 0.1, 0.1],
                             [0.033, 0.033, 0.067, 0.067])])
TINY_CASCADE_MASK_RCNN = dict(TINY_CASCADE_RCNN,
                              mask_head=TINY_MASK_RCNN["mask_head"],
                              test_cfg=TINY_MASK_RCNN["test_cfg"])
TINY_POINT_REND = dict(
    TINY_MASK_RCNN, type="PointRend",
    mask_head=dict(type="CoarseMaskHead", num_classes=20, in_channels=32,
                   roi_size=14, num_convs=0, conv_out_channels=32, num_fcs=2,
                   fc_out_channels=64, downsample_factor=2),
    point_head=dict(type="MaskPointHead", num_classes=20, num_fcs=3,
                    in_channels=32, fc_channels=32,
                    coarse_pred_each_layer=True),
    test_cfg=dict(TINY_MASK_RCNN["test_cfg"], subdivision_steps=2,
                  subdivision_num_points=196, scale_factor=2))
TINY_YOLACT = dict(
    type="YOLACT",
    backbone=dict(_TINY_BACKBONE, frozen_stages=-1, norm_eval=False,
                  zero_init_residual=False),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, num_outs=5, add_extra_convs="on_input",
              upsample_cfg=dict(mode="bilinear")),
    bbox_head=dict(type="YOLACTHead", num_classes=20, in_channels=32,
                   feat_channels=32, num_head_convs=1, num_protos=8,
                   anchor_generator=dict(octave_base_scale=3,
                                         scales_per_octave=1,
                                         ratios=[0.5, 1.0, 2.0],
                                         strides=[8, 16, 32, 64, 128])),
    segm_head=dict(type="YOLACTSegmHead", num_classes=20, in_channels=32),
    mask_head=dict(type="YOLACTProtonet", num_protos=8, in_channels=32,
                   proto_channels=(32, 32, 32), loss_mask_weight=6.125),
    test_cfg=dict(nms_pre=1000, score_thr=0.05, iou_thr=0.5,
                  nms=dict(iou_threshold=0.5), max_per_img=100))
_SEESAW = dict(type="SeesawLoss", p=0.8, q=2.0, loss_weight=1.0)
TINY_SEESAW = dict(
    TINY_MASK_RCNN,
    bbox_head=dict(TINY_MASK_RCNN["bbox_head"], loss_cls=_SEESAW),
    mask_head=dict(TINY_MASK_RCNN["mask_head"],
                   predictor_cfg=dict(type="NormedConv2d", tempearture=20)))
_TINY_SEMANTIC = dict(type="FusedSemanticHead", num_ins=5, fusion_level=1,
                      num_convs=1, in_channels=32, conv_out_channels=32,
                      num_classes=24, loss_weight=0.2)
TINY_HTC = dict(
    TINY_CASCADE_RCNN, type="HTC",
    mask_heads=[dict(type="HTCMaskHead", num_classes=20, in_channels=32,
                     conv_out_channels=32, num_convs=2, roi_size=14,
                     with_conv_res=i > 0) for i in range(3)],
    semantic_head=_TINY_SEMANTIC, test_cfg=TINY_MASK_RCNN["test_cfg"])
TINY_SCNET = dict(
    TINY_CASCADE_RCNN, type="SCNet",
    bbox_heads=[dict(type="SCNetBBoxHead", num_classes=20, in_channels=32,
                     roi_size=7, fc_channels=64, target_stds=stds)
                for stds in ([0.1, 0.1, 0.2, 0.2], [0.05, 0.05, 0.1, 0.1],
                             [0.033, 0.033, 0.067, 0.067])],
    mask_head=dict(type="SCNetMaskHead", num_classes=20, in_channels=32,
                   conv_out_channels=32, num_convs=2, roi_size=14),
    semantic_head=_TINY_SEMANTIC,
    glbctx_head=dict(type="GlobalContextHead", num_convs=2, in_channels=32,
                     conv_out_channels=32, num_classes=20, loss_weight=3.0,
                     conv_to_res=True),
    relay_head=dict(type="FeatureRelayHead", in_channels=64,
                    out_conv_channels=32, roi_feat_size=7, scale_factor=2),
    test_cfg=TINY_MASK_RCNN["test_cfg"])
_TINY_DETECTORS_BACKBONE = dict(type="DetectoRSResNet", depth=50,
                                out_indices=(0, 1, 2, 3),
                                sac_stages=(1, 2, 3), rfp_inplanes=32)
TINY_DETECTORS_FASTER = dict(
    TINY_FASTER_RCNN, type="DetectoRS", backbone=_TINY_DETECTORS_BACKBONE,
    neck=dict(type="RFP", in_channels=[256, 512, 1024, 2048],
              out_channels=32, num_outs=5, rfp_steps=2, aspp_out_channels=8,
              rfp_backbone=_TINY_DETECTORS_BACKBONE))
# slice 16's backbones on the tiny detectors: HRNet at a few blocks and
# narrow branches (its stem stays 64 wide, as in both packages), RegNet's
# shallowest arch (16 blocks), ResNeSt-50 and Res2Net-50 with narrow stems / stages (the
# packages have no shallower depth), MobileNetV2 at a quarter width
_TINY_HRNET = dict(type="HRNet", extra=dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(1, 1), num_channels=(4, 8)),
    stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                num_blocks=(1, 1, 1), num_channels=(4, 8, 16)),
    stage4=dict(num_modules=2, num_branches=4, block="BASIC",
                num_blocks=(1, 2, 1, 1), num_channels=(4, 8, 16, 32))))
_TINY_HRFPN = dict(type="HRFPN", in_channels=[4, 8, 16, 32], out_channels=32,
                   num_outs=5)
TINY_HRNET_FASTER = dict(TINY_FASTER_RCNN, backbone=_TINY_HRNET,
                         neck=_TINY_HRFPN)
TINY_HRNET_FCOS = dict(
    type="FCOS", backbone=_TINY_HRNET, neck=_TINY_HRFPN,
    bbox_head=dict(type="FCOSHead", num_classes=20, in_channels=32,
                   stacked_convs=1, feat_channels=32,
                   strides=[8, 16, 32, 64, 128], norm_on_bbox=True,
                   centerness_on_reg=True, center_sampling=True),
    test_cfg=dict(nms_pre=1000, score_thr=0.05,
                  nms=dict(iou_threshold=0.6), max_per_img=100))
TINY_REGNET_MASK = dict(
    TINY_MASK_RCNN,
    backbone=dict(type="RegNet", arch="regnetx_800mf", out_indices=(0, 1, 2, 3),
                  frozen_stages=1),
    neck=dict(TINY_MASK_RCNN["neck"], in_channels=[64, 128, 288, 672]))
TINY_RESNEST_FASTER = dict(
    TINY_FASTER_RCNN,
    backbone=dict(type="ResNeSt", depth=50, radix=2, groups=1, base_width=4,
                  stem_channels=16, out_indices=(0, 1, 2, 3)),
    neck=dict(TINY_FASTER_RCNN["neck"], in_channels=[256, 512, 1024, 2048]))
TINY_RES2NET_FASTER = dict(
    TINY_FASTER_RCNN,
    backbone=dict(type="Res2Net", depth=50, scales=4, base_width=26,
                  base_channels=16, out_indices=(0, 1, 2, 3),
                  frozen_stages=1),
    neck=dict(TINY_FASTER_RCNN["neck"], in_channels=[64, 128, 256, 512]))
TINY_SSD_MOBILENET = dict(
    type="SSD",
    backbone=dict(type="MobileNetV2", widen_factor=0.25,
                  out_indices=(1, 2, 4, 6)),
    neck=dict(type="FPN", in_channels=[8, 8, 24, 80], out_channels=32,
              start_level=0, add_extra_convs="on_output", num_outs=5),
    bbox_head=dict(type="SSDHead", num_classes=20,
                   in_channels=(32, 32, 32, 32, 32), strides=[4, 8, 16, 32, 64]),
    test_cfg=dict(nms_pre=1000, score_thr=0.02,
                  nms=dict(type="nms", iou_threshold=0.45), max_per_img=100))
TINY_SSD = dict(
    type="SSD",
    backbone=dict(type="ResNet", depth=18, out_indices=(2, 3),
                  frozen_stages=1, style="pytorch"),
    neck=dict(type="SSDNeck", in_channels=(256, 512),
              out_channels=(256, 512, 64, 64), level_strides=(2, 2),
              level_paddings=(1, 1), l2_norm_scale=20),
    bbox_head=dict(
        type="SSDHead", num_classes=20, in_channels=(256, 512, 64, 64),
        strides=(16, 32, 64, 128),
        anchor_generator=dict(
            type="SSDAnchorGenerator", strides=(16, 32, 64, 128),
            ratios=([2], [2, 3], [2, 3], [2]), min_sizes=(19, 38, 70, 102),
            max_sizes=(38, 70, 102, 134)),
        bbox_coder=dict(type="DeltaXYWHBBoxCoder",
                        target_means=[0.0, 0.0, 0.0, 0.0],
                        target_stds=[0.1, 0.1, 0.2, 0.2])),
    test_cfg=dict(nms_pre=1000, score_thr=0.02,
                  nms=dict(type="nms", iou_threshold=0.45), max_per_img=200))

# slice 17's deformable parts on the tiny detectors: a ResNet-50 at a
# quarter width (the packages' smallest bottleneck depth) with DCNv2 and 2
# offset groups in c5 alone (the JAX package traces each deformable conv
# tap by tap and group by group: c3-c5 at 4 groups takes 14 s to trace),
# the deformable RoI pooling packs at 64 wide, FCOS (caffe, GN head) with
# DCN in c5 and DCNv2 on the towers' last conv, VFNet with both, 2-conv
# towers 32 wide
_TINY_DCN_BACKBONE = dict(type="ResNet", depth=50, stem_channels=16,
                          base_channels=16, out_indices=(0, 1, 2, 3),
                          frozen_stages=1, style="pytorch",
                          dcn=dict(type="DCNv2", deform_groups=2),
                          stage_with_dcn=(False, False, False, True))
TINY_DCN_FASTER = dict(TINY_FASTER_RCNN, backbone=_TINY_DCN_BACKBONE)
TINY_DPOOL_FASTER = dict(
    TINY_FASTER_RCNN,
    roi_pool_pack=dict(type="DeformRoIPoolPack", output_size=7,
                       output_channels=32, deform_fc_channels=64))
TINY_MDPOOL_FASTER = dict(
    TINY_FASTER_RCNN,
    roi_pool_pack=dict(type="ModulatedDeformRoIPoolPack", output_size=7,
                       output_channels=32, deform_fc_channels=64))
TINY_FCOS_DCN = dict(
    type="FCOS",
    backbone=dict(_TINY_DCN_BACKBONE, style="caffe", dcn=dict(type="DCN")),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs="on_output", num_outs=5,
              relu_before_extra_convs=True),
    bbox_head=dict(type="FCOSHead", num_classes=20, in_channels=32,
                   stacked_convs=2, feat_channels=32,
                   strides=[8, 16, 32, 64, 128], norm_on_bbox=True,
                   centerness_on_reg=True, center_sampling=True,
                   dcn_on_last_conv=True, conv_bias=True,
                   norm_cfg=dict(type="GN", num_groups=32)),
    test_cfg=dict(nms_pre=1000, score_thr=0.05,
                  nms=dict(iou_threshold=0.6), max_per_img=100))
TINY_VFNET = dict(
    type="VFNet", backbone=dict(_TINY_DCN_BACKBONE, dcn=dict(type="DCNv2")),
    neck=TINY_FCOS_DCN["neck"],
    bbox_head=dict(type="VFNetHead", num_classes=20, in_channels=32,
                   feat_channels=32, stacked_convs=2,
                   strides=[8, 16, 32, 64, 128], gradient_mul=0.1,
                   dcn_on_last_conv=True),
    test_cfg=dict(nms_pre=1000, score_thr=0.05,
                  nms=dict(iou_threshold=0.6), max_per_img=100))

# the plugins and necks: a ResNet-50 at a quarter width with GCNet's ContextBlock in
# c3-c5 and GeneralizedAttention ('1111', kv_stride 2) in c4-c5 (their JAX
# packages' own blocks), the other necks at 32 wide (NAS-FPN
# and FPG at stack_times 2), Libra's Balanced L1, RetinaSepBNHead, NAS-FCOS
_GCB = dict(cfg=dict(type="ContextBlock", ratio=1. / 4),
            stages=(False, True, True, True), position="after_conv3")
_ATTENTION = dict(cfg=dict(type="GeneralizedAttention", spatial_range=-1,
                           num_heads=8, attention_type="1111", kv_stride=2),
                  stages=(False, False, True, True), position="after_conv2")
_TINY_PLUGIN_BACKBONE = dict(type="ResNet", depth=50, stem_channels=16,
                             base_channels=16, out_indices=(0, 1, 2, 3),
                             frozen_stages=1, style="pytorch",
                             plugins=[_GCB, _ATTENTION])
TINY_GCB_MASK_RCNN = dict(
    TINY_MASK_RCNN, backbone=dict(_TINY_PLUGIN_BACKBONE, plugins=[_GCB]))
TINY_ATTENTION_FASTER = dict(
    TINY_FASTER_RCNN, backbone=dict(_TINY_PLUGIN_BACKBONE,
                                    plugins=[_ATTENTION]))
TINY_PAFPN_FASTER = dict(
    TINY_FASTER_RCNN, neck=dict(TINY_FASTER_RCNN["neck"], type="PAFPN"))
TINY_CARAFE_FASTER = dict(
    TINY_FASTER_RCNN,
    neck=dict(type="FPN_CARAFE", in_channels=[64, 128, 256, 512],
              out_channels=32, num_outs=5))
_BALANCED_L1 = dict(type="BalancedL1Loss", alpha=0.5, gamma=1.5, beta=1.0,
                    loss_weight=1.0)
TINY_LIBRA_FASTER = dict(
    TINY_FASTER_RCNN,
    neck=[TINY_FASTER_RCNN["neck"],
          dict(type="BFP", in_channels=32, num_levels=5, refine_level=2,
               refine_type="non_local")],
    bbox_head=dict(TINY_FASTER_RCNN["bbox_head"], loss_bbox=_BALANCED_L1),
    train_cfg=dict(rcnn=dict(sampler=dict(
        type="CombinedSampler", num=512, pos_fraction=0.25,
        add_gt_as_proposals=True,
        pos_sampler=dict(type="InstanceBalancedPosSampler"),
        neg_sampler=dict(type="IoUBalancedNegSampler", floor_thr=-1,
                         floor_fraction=0, num_bins=3)))))
TINY_LIBRA_RETINANET = dict(
    TINY_RETINANET,
    neck=[TINY_RETINANET["neck"],
          dict(type="BFP", in_channels=32, num_levels=5, refine_level=2,
               refine_type="conv")],
    bbox_head=dict(TINY_RETINANET["bbox_head"],
                   loss_bbox=dict(_BALANCED_L1, beta=0.11)))
TINY_NASFPN_RETINANET = dict(
    TINY_RETINANET,
    neck=dict(type="NASFPN", in_channels=[128, 256, 512], out_channels=32,
              num_outs=5, stack_times=2, start_level=1),
    bbox_head=dict(TINY_RETINANET["bbox_head"], type="RetinaSepBNHead",
                   num_ins=5))
TINY_FPG_FASTER = dict(
    TINY_FASTER_RCNN,
    neck=dict(type="FPG", in_channels=[64, 128, 256, 512], out_channels=32,
              num_outs=5, stack_times=2))
TINY_FPG_RETINANET = dict(TINY_RETINANET, neck=TINY_FPG_FASTER["neck"])
TINY_NASFCOS = dict(
    type="FCOS",
    backbone=dict(_TINY_BACKBONE, style="caffe"),
    neck=dict(type="NASFCOS_FPN", in_channels=[128, 256, 512],
              out_channels=32, num_outs=5),
    bbox_head=dict(type="NASFCOSHead", num_classes=20, in_channels=32,
                   feat_channels=32, strides=[8, 16, 32, 64, 128],
                   norm_on_bbox=True, centerness_on_reg=True,
                   center_sampling=True, conv_bias=True,
                   norm_cfg=dict(type="GN", num_groups=32)),
    test_cfg=dict(nms_pre=1000, score_thr=0.05,
                  nms=dict(iou_threshold=0.6), max_per_img=100))


def ssd_pipeline(pipeline: list) -> list:
    """A copy of an SSD pipeline (``configs/_base_/datasets/wider_face.py``'s
    is the repo's SSD-300 protocol) that both packages build: mmdet's
    ``Expand(to_rgb=True)`` fills with the mean given in RGB order reversed
    to the image's BGR, and neither package's ``Expand`` takes ``to_rgb``,
    so the mean is reversed here and the key dropped."""
    out = copy.deepcopy(list(pipeline))
    for step in out:
        if step.get("type") == "Expand" and "to_rgb" in step:
            if step.pop("to_rgb"):
                step["mean"] = list(step["mean"])[::-1]
    return out


def voc_detector_config(cfg: dict, voc: dict) -> dict:
    """A copy of a ``configs/pascal_voc/`` detector config (a plain dict)
    whose ``data.train`` / ``val`` / ``test`` read the VOC2007 directory
    ``voc`` (as :func:`make_voc_dir` returns it): train on its trainval
    split with the config's ``train_pipeline``, val and test on its test
    split with its ``test_pipeline`` (the config's blocks replace their
    base's and name no pipeline)."""
    cfg = copy.deepcopy(cfg)
    prefix = voc["voc_root"].rstrip("/") + "/"
    data = cfg["data"]
    for key, split, pipeline in (("train", "trainval", "train_pipeline"),
                                 ("val", "test", "test_pipeline"),
                                 ("test", "test", "test_pipeline")):
        data[key] = dict(type="VOCDataset", ann_file=voc[split],
                         img_prefix=prefix,
                         pipeline=copy.deepcopy(cfg[pipeline]))
    return cfg


# the segmentation forms of a synthetic instance, in turn
SEGM_KINDS = ("polygon", "polygons", "rle", "crowd", "polygon", "none")


def _instance(rng: np.random.RandomState, h: int, w: int, kind: str) -> dict:
    """One seeded COCO annotation (no ids) of ``kind`` (``SEGM_KINDS``): a
    star-shaped polygon in a random box (two for "polygons"; its mask as an
    uncompressed RLE for "rle" and "crowd"); bbox and area from the mask."""
    from dsl_tpu_torch.core.masks import encode_rle, rasterize_polygons

    x1, y1, x2, y2 = _boxes(rng, h, w, 1)[0]
    polys = []
    for _ in range(2 if kind == "polygons" else 1):
        n = rng.randint(5, 13)
        # gaps under pi: the polygon holds its centre
        ang = (np.arange(n) + rng.uniform(0, 0.8, n)) * (2 * np.pi / n)
        rad = rng.uniform(0.4, 1.0, n)
        cx = rng.uniform(x1, x2) if polys else (x1 + x2) / 2
        cy = rng.uniform(y1, y2) if polys else (y1 + y2) / 2
        pts = np.stack([cx + (x2 - x1) / 2 * rad * np.cos(ang),
                        cy + (y2 - y1) / 2 * rad * np.sin(ang)], 1)
        pts[:, 0] = np.clip(pts[:, 0], 0, w)
        pts[:, 1] = np.clip(pts[:, 1], 0, h)
        polys.append(np.round(pts, 2).reshape(-1).tolist())
    mask = rasterize_polygons(polys, h, w).numpy()
    ys, xs = np.nonzero(mask)
    bx1, by1, bx2, by2 = (float(xs.min()), float(ys.min()),
                          float(xs.max() + 1), float(ys.max() + 1))
    ann = dict(bbox=[bx1, by1, bx2 - bx1, by2 - by1], area=float(mask.sum()),
               iscrowd=int(kind == "crowd"))
    if kind in ("rle", "crowd"):
        ann["segmentation"] = encode_rle(mask)
    elif kind != "none":
        ann["segmentation"] = polys
    return ann


def _coco_split(root: Path, split: str, sources, count: int, categories,
                rng: np.random.RandomState, kinds) -> str:
    img_dir = root / split
    img_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i in range(count):
        src, h, w = sources[i % len(sources)]
        name = f"{split}_{i:03d}{Path(src).suffix}"
        shutil.copyfile(src, img_dir / name)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        for j in range(rng.randint(2, 6)):
            ann = _instance(rng, h, w, kinds[(i + j) % len(kinds)])
            ann.update(id=len(annotations) + 1, image_id=i + 1,
                       category_id=int(rng.randint(1, len(categories) + 1)))
            annotations.append(ann)
    path = root / f"{split}.json"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dict(images=images, categories=categories,
                       annotations=annotations), f)
    return str(path)


def make_coco_instance_dir(root, sources: list[tuple[str, int, int]],
                           n_train: int, n_val: int, seed: int = 0) -> dict:
    """A COCO instance set of copies of ``sources`` ((image path, height,
    width)), 2-5 seeded instances per image, 80 COCO categories:
    ``train/``, ``train.json``, ``val/``, ``val.json`` (the val split has
    no instance without a segmentation: the segm protocol reads each GT's).
    Returns the paths."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    categories = [dict(id=i + 1, name=c) for i, c in enumerate(COCO_CLASSES)]
    train = _coco_split(root, "train", sources, n_train, categories, rng,
                        SEGM_KINDS)
    val = _coco_split(root, "val", sources, n_val, categories, rng,
                      SEGM_KINDS[:-1])
    return dict(train=train, train_images=str(root / "train") + "/",
                val=val, val_images=str(root / "val") + "/")


def coco_instance_config(cfg: dict, paths: dict) -> dict:
    """A copy of a COCO config (a plain dict) whose ``data.train`` reads
    :func:`make_coco_instance_dir`'s train split and ``val`` / ``test`` its
    val split, each with its own pipeline as the config writes it."""
    cfg = copy.deepcopy(cfg)
    data = cfg["data"]
    for key, split in (("train", "train"), ("val", "val"), ("test", "val")):
        data[key].update(type="CocoDataset", ann_file=paths[split],
                         img_prefix=paths[f"{split}_images"])
    return cfg
