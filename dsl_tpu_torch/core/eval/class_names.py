"""Class names of the named datasets.

The port's copy of ``dsl_tpu/core/eval/class_names.py``: ``get_classes``
of ``'coco'``, ``'voc'`` (or ``'pascal_voc'``), ``'cityscapes'``,
``'wider_face'`` (or ``'widerface'``) and ``'deepfashion'`` gives the
dataset's label list.
"""

from __future__ import annotations

CITYSCAPES_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                      "motorcycle", "bicycle")
DEEPFASHION_CLASSES = ("top", "skirt", "leggings", "dress", "outer", "pants",
                       "bag", "neckwear", "headwear", "eyeglass", "belt",
                       "footwear", "hair", "skin", "face")


def coco_classes():
    from dsl_tpu_torch.data.datasets.coco import COCO_CLASSES

    return list(COCO_CLASSES)


def voc_classes():
    from dsl_tpu_torch.data.datasets.voc import VOC_CLASSES

    return list(VOC_CLASSES)


def cityscapes_classes():
    return list(CITYSCAPES_CLASSES)


def wider_face_classes():
    return ["face"]


def deepfashion_classes():
    return list(DEEPFASHION_CLASSES)


_ALIASES = {
    "coco": coco_classes,
    "voc": voc_classes, "pascal_voc": voc_classes,
    "cityscapes": cityscapes_classes,
    "wider_face": wider_face_classes, "widerface": wider_face_classes,
    "deepfashion": deepfashion_classes,
}


def get_classes(dataset: str) -> list[str]:
    """Class names of a named dataset; an unknown name raises ValueError."""
    key = dataset.lower()
    if key not in _ALIASES:
        raise ValueError(f"Unrecognized dataset: {dataset} "
                         f"(known: {sorted(_ALIASES)})")
    return _ALIASES[key]()
