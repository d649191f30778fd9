"""The port's data layer against the JAX package's, on the CPU.

The same inputs go through ``dsl_tpu.data`` and ``dsl_tpu_torch.data``;
the JAX package draws from the global ``np.random`` after
``np.random.seed(s)``, the port from ``np.random.RandomState(s)``, in the
same call order. Tolerances:

- sampler orders (one process, and each rank of two), dataset image lists,
  group flags and annotations
  (``get_ann_info``, with the fixed-pair and adathres ignore split): exact;
- ``Resize``: pixels within 1 level (``cv2.resize`` works in fixed point,
  the port in float and rounds), boxes and scale factors 1e-4;
  ``RandomFlip`` and ``Pad``: exact; ``Normalize``: 1e-5;
- batches of ``MultiDataLoader`` (2 labeled, 2 unlabeled and the half-res
  copy): the same keys, shapes (images NCHW in the port), dtypes as
  ``utils/random_batch.to_torch`` makes them, GT, masks, source weights and
  ``si_pair`` exact, image values within 1 level over the normalization's
  std (1 / 57.12) plus 1e-5;
- a transform the port lacks (``Albu``) raises ``NotImplementedError``
  naming it;
- ``ZeroIgnore`` on 16 seeds (ignore boxes that overlap a GT box or not,
  some past the image's edge): images bit-identical, both generators left
  in the same state;
- the dataset wrappers, built from ``type=`` configs by
  ``apis/train.build_dataset``, against JAX's classes over the same
  datasets: lengths, group flags, ``CLASSES``, every index's annotations,
  ``ClassBalancedDataset``'s repeat factors and indices: exact.
"""

import copy
import json

import numpy as np
import pytest
import torch

from dsl_tpu.data import datasets as jax_datasets  # noqa: F401 (registers)
from dsl_tpu.data.loader import DetDataLoader as JaxLoader
from dsl_tpu.data.loader import MultiDataLoader as JaxMulti
from dsl_tpu.data.pipelines import transforms as jax_tf
from dsl_tpu.data.samplers import DistributedGroupSampler as JaxDistributedSampler
from dsl_tpu.data.samplers import GroupSampler as JaxSampler
from dsl_tpu.registry import DATASETS as JAX_DATASETS
from dsl_tpu.registry import build_from_cfg as jax_build
from dsl_tpu_torch.data import datasets  # noqa: F401 (registers)
from dsl_tpu_torch.data.loader import DetDataLoader, MultiDataLoader
from dsl_tpu_torch.data.pipelines import Compose
from dsl_tpu_torch.data.pipelines import transforms as tf
from dsl_tpu_torch.data.samplers import DistributedGroupSampler, GroupSampler
from dsl_tpu_torch.registry import DATASETS, build_from_cfg
from dsl_tpu_torch.utils import synthetic_data
from dsl_tpu_torch.utils.random_batch import to_torch
from torch_port_make_fixtures import FIXTURES, OUT, load_decodes

torch.set_num_threads(2)

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
# the flagship's pipeline without its strong augmentations, at the tiny size
PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=[(96, 64), (96, 48)],
         multiscale_mode="value", keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
]
LEVEL = 1 / 57.12 + 1e-5      # one level after the normalization


class _Flags:
    def __init__(self, flag):
        self.flag = np.asarray(flag, np.uint8)


@pytest.mark.parametrize("per_gpu", [1, 2, 3])
def test_sampler_orders_equal_jax(per_gpu):
    flag = np.random.RandomState(per_gpu).randint(0, 2, 23)
    for seed in (0, 5):
        port = GroupSampler(_Flags(flag), per_gpu, seed=seed)
        ref = JaxSampler(_Flags(flag), per_gpu, seed=seed)
        assert len(port) == len(ref)
        for epoch in range(3):
            assert list(port.set_epoch(epoch)) == list(ref.set_epoch(epoch))
    # over two replicas: each rank's order is the JAX package's
    for rank in range(2):
        port = DistributedGroupSampler(_Flags(flag), per_gpu, num_replicas=2,
                                       rank=rank, seed=5)
        ref = JaxDistributedSampler(_Flags(flag), per_gpu, num_replicas=2,
                                    rank=rank, seed=5)
        assert len(port) == len(ref)
        assert list(port.set_epoch(1)) == list(ref.set_epoch(1))


@pytest.fixture(scope="module")
def semicoco(tmp_path_factory):
    root = tmp_path_factory.mktemp("semicoco")
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    paths = synthetic_data.make_semicoco_dir(root, sources, 4, 4)
    # scores across both thresholds on one unlabeled file, as a refresh
    # writes them
    name = "unlabeled_001.jpg"
    store = f"{paths['unlabel_store']}/{name}.json"
    data = json.load(open(store))
    data.update(targetNum=5, tags=["person", "car", "person", "dog", "car"],
                rects=[[10, 10, 50, 60], [20, 30, 90, 80], [5, 5, 6, 6],
                       [100, 100, 180, 200], [0, 0, 700, 20]],
                scores=[0.9, 0.35, 0.5, 0.12, 0.05])
    json.dump(data, open(store, "w"))
    json.dump(dict(thres={"person": 0.32, "car": 0.3, "dog": 0.34}),
              open(paths["adathres"], "w"))
    return paths


def _dataset_cfg(paths, split, thres=None):
    cfg = dict(type="SemiCOCODataset", ann_file=paths[split],
               ann_path=paths["label_store" if split == "labeled"
                              else "unlabel_store"],
               labelmapper=paths["category_info"], img_prefix=paths["images"],
               pipeline=PIPELINE)
    if thres is not None:
        cfg["thres"] = thres
    return cfg


@pytest.mark.parametrize("thres", [None, [0.1, 0.4], "adathres"])
def test_semicoco_annotations_equal_jax(semicoco, thres):
    if thres == "adathres":
        thres = semicoco["adathres"]
    for split in ("labeled", "unlabeled"):
        cfg = _dataset_cfg(semicoco, split, thres)
        ref = jax_build(copy.deepcopy(cfg), JAX_DATASETS)
        port = build_from_cfg({**cfg, "device": "cpu"}, DATASETS)
        assert port.data_infos == ref.data_infos
        assert port.img_ids == ref.img_ids
        np.testing.assert_array_equal(port.flag, ref.flag)
        for i in range(len(ref)):
            got, want = port.get_ann_info(i), ref.get_ann_info(i)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
    # the file with scores splits into GT, ignore and dropped boxes
    if thres is not None:
        i = [d["filename"] for d in port.data_infos].index("unlabeled_001.jpg")
        ann = port.get_ann_info(i)
        assert len(ann["bboxes"]) and len(ann["bboxes_ignore"])


def _results(seed: int):
    """A decoded fixture (the committed cv2 decode) with GT and ignore
    boxes, as LoadImageFromFile + LoadAnnotations leave it."""
    name = sorted(FIXTURES)[seed % len(FIXTURES)]
    img = load_decodes()[name]
    h, w = img.shape[:2]
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, w / 2, 5), rng.uniform(0, h / 2, 5)
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, w / 2, 5),
                      y1 + rng.uniform(5, h / 2, 5)], 1).astype(np.float32)
    return dict(img=img, gt_bboxes=boxes[:3], gt_bboxes_ignore=boxes[3:],
                gt_labels=np.arange(3), bbox_fields=["gt_bboxes",
                                                     "gt_bboxes_ignore"])


def _both(results):
    port = {k: (v.copy() if isinstance(v, np.ndarray) else list(v)
                if isinstance(v, list) else v) for k, v in results.items()}
    port["img"] = torch.from_numpy(results["img"].copy())
    ref = {k: (v.copy() if isinstance(v, (np.ndarray, list)) else v)
           for k, v in results.items()}
    return port, ref


def _run(port_t, ref_t, results, seed):
    port, ref = _both(results)
    np.random.seed(seed)
    ref = ref_t(ref)
    port = port_t(port, np.random.RandomState(seed))
    return port, ref


@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_jax(seed):
    cfg = dict(img_scale=[(96, 64), (96, 48), (1333, 800)],
               multiscale_mode="value", keep_ratio=True)
    port, ref = _run(tf.Resize(**cfg), jax_tf.Resize(**cfg), _results(seed), seed)
    assert port["scale"] == ref["scale"] and port["scale_idx"] == ref["scale_idx"]
    assert port["img"].dtype == torch.uint8 and port["img"].shape == ref["img"].shape
    np.testing.assert_array_equal(port["img"].numpy(), ref["img"])
    for k in ("gt_bboxes", "gt_bboxes_ignore", "scale_factor"):
        np.testing.assert_allclose(port[k], ref[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_flip_normalize_pad_match_jax(seed):
    results = _results(seed)
    port, ref = _run(tf.RandomFlip(flip_ratio=0.5),
                     jax_tf.RandomFlip(flip_ratio=0.5), results, seed)
    assert port["flip"] == ref["flip"]
    np.testing.assert_array_equal(port["img"].numpy(), ref["img"])
    for k in ("gt_bboxes", "gt_bboxes_ignore"):
        np.testing.assert_array_equal(port[k], ref[k])
    port = tf.Normalize(**NORM)(port, None)
    ref = jax_tf.Normalize(**NORM)(ref)
    np.testing.assert_allclose(port["img"].numpy(), ref["img"], atol=1e-5)
    port = tf.Pad(size_divisor=32)(port, None)
    ref = jax_tf.Pad(size_divisor=32)(ref)
    assert port["pad_shape"] == ref["pad_shape"]
    np.testing.assert_array_equal(port["img"].numpy(), ref["img"])


def _loaders(paths, seed, port: bool):
    """A labeled and an unlabeled dataset sharing one random source, and
    their MultiDataLoader (the JAX one with one worker: draws in order)."""
    kw = dict(canvas_hw=(64, 96))
    if port:
        rng = np.random.RandomState(seed)
        ds = [build_from_cfg({**_dataset_cfg(paths, s, [0.1, 0.4]),
                              "device": "cpu", "rng": rng}, DATASETS)
              for s in ("labeled", "unlabeled")]
        return MultiDataLoader(DetDataLoader(ds[0], 2, seed=seed, **kw),
                               DetDataLoader(ds[1], 2, seed=seed + 1, **kw),
                               unlabel_weight=3.0, scale_invariant=True)
    np.random.seed(seed)
    ds = [jax_build(_dataset_cfg(paths, s, [0.1, 0.4]), JAX_DATASETS)
          for s in ("labeled", "unlabeled")]
    return JaxMulti(JaxLoader(ds[0], 2, 1, seed=seed, **kw),
                    JaxLoader(ds[1], 2, 1, seed=seed + 1, **kw),
                    unlabel_weight=3.0, scale_invariant=True)


def test_multi_loader_batches_equal_jax(semicoco):
    port_it = iter(_loaders(semicoco, 3, port=True))
    ref_loader = _loaders(semicoco, 3, port=False)
    assert len(ref_loader) == 2
    for ref in ref_loader:
        got = next(port_it)
        ref.pop("meta")
        assert len(got.pop("meta")) == 5
        want = to_torch(ref, "cpu")
        assert set(got) == set(want)
        for k, w in want.items():
            if k == "si_pair":
                assert {n: v.tolist() for n, v in got[k].items()} == {
                    n: v.tolist() for n, v in w.items()}
                continue
            g = got[k]
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if k == "images":
                assert float((g - w).abs().max()) <= LEVEL
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                           err_msg=k)
        assert got["source_weight"].tolist() == [1.0, 1.0, 3.0, 3.0, 3.0]
        assert int(got["gt_valid"][4].sum()) == int(got["gt_valid"][3].sum())


def test_one_source_loader_batches_equal_jax(semicoco):
    rng = np.random.RandomState(2)
    port = DetDataLoader(build_from_cfg({**_dataset_cfg(semicoco, "labeled"),
                                         "device": "cpu", "rng": rng},
                                        DATASETS), 2, seed=2, canvas_hw=(64, 96))
    np.random.seed(2)
    ref = JaxLoader(jax_build(_dataset_cfg(semicoco, "labeled"), JAX_DATASETS),
                    2, 1, seed=2, canvas_hw=(64, 96))
    assert len(port) == len(ref) == 2
    assert port.upcoming_indices() == ref.upcoming_indices()
    for got, want in zip(port, ref):
        want.pop("meta")
        got.pop("meta")
        want = to_torch(want, "cpu")
        assert set(got) == set(want) and "si_pair" not in got
        assert float((got["images"] - want["images"]).abs().max()) <= LEVEL
        for k in ("gt_bboxes", "gt_labels", "gt_valid", "source_weight"):
            assert torch.equal(got[k], want[k]), k


def test_compose_refuses_an_unported_transform():
    with pytest.raises(NotImplementedError, match="Albu"):
        Compose(PIPELINE[:3] + [dict(type="Albu", transforms=[])])


def test_multiscale_flip_aug_matches_jax():
    """The test pipeline's wrapper at one scale, without flip: Resize to the
    scale, Normalize, Pad, every key a one-element list."""
    inner = [dict(type="Resize", keep_ratio=True), dict(type="RandomFlip"),
             dict(type="Normalize", **NORM), dict(type="Pad", size_divisor=32)]
    port, ref = _run(tf.MultiScaleFlipAug(inner, img_scale=(96, 64)),
                     jax_tf.MultiScaleFlipAug(inner, img_scale=(96, 64)),
                     _results(1), 0)
    assert set(port) == set(ref) and len(port["img"]) == 1
    assert port["img_shape"] == [tuple(s) for s in ref["img_shape"]]
    assert port["flip"] == ref["flip"] == [False]
    assert float(np.abs(port["img"][0].numpy() - ref["img"][0]).max()) <= LEVEL
    np.testing.assert_allclose(port["gt_bboxes"][0], ref["gt_bboxes"][0],
                               atol=1e-4)


def _ignore_results(seed: int):
    """A decode with 3 GT boxes in its left half and 6 ignore boxes
    anywhere, some reaching past the image's edges."""
    name = sorted(FIXTURES)[seed % len(FIXTURES)]
    img = load_decodes()[name]
    h, w = img.shape[:2]
    rng = np.random.RandomState(100 + seed)

    def boxes(n, x_hi):
        x1, y1 = rng.uniform(-20, x_hi, n), rng.uniform(-20, h, n)
        return np.stack([x1, y1, x1 + rng.uniform(2, w / 3, n),
                         y1 + rng.uniform(2, h / 3, n)], 1).astype(np.float32)

    return dict(img=img, gt_bboxes=boxes(3, w / 2), gt_labels=np.arange(3),
                gt_bboxes_ignore=boxes(6, w),
                bbox_fields=["gt_bboxes", "gt_bboxes_ignore"])


@pytest.mark.parametrize("seed", range(16))
def test_zero_ignore_matches_jax(seed):
    fill = (0, 0, 0) if seed % 2 else (7, 128, 255)
    port, ref = _both(_ignore_results(seed))
    np.random.seed(seed)
    ref = jax_tf.ZeroIgnore(ratio=0.6, fill_in=fill)(ref)
    rng = np.random.RandomState(seed)
    port = tf.ZeroIgnore(ratio=0.6, fill_in=fill)(port, rng)
    np.testing.assert_array_equal(port["img"].numpy(), ref["img"])
    assert rng.rand() == np.random.rand()
    np.testing.assert_array_equal(port["gt_bboxes_ignore"],
                                  ref["gt_bboxes_ignore"])


def _same_dataset(port, ref):
    assert len(port) == len(ref)
    assert tuple(port.CLASSES) == tuple(ref.CLASSES)
    np.testing.assert_array_equal(port.flag, ref.flag)
    assert port.flag.dtype == ref.flag.dtype
    for i in range(len(ref)):
        got, want = port.get_ann_info(i), ref.get_ann_info(i)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")


def test_dataset_wrappers_equal_jax(semicoco):
    from dsl_tpu.data.datasets import wrappers as jax_wrappers
    from dsl_tpu_torch.apis.train import build_dataset

    lab, unl = (_dataset_cfg(semicoco, s, [0.1, 0.4])
                for s in ("labeled", "unlabeled"))
    ref_lab, ref_unl = (jax_build(copy.deepcopy(c), JAX_DATASETS)
                        for c in (lab, unl))
    rng, pyrng = np.random.RandomState(0), None

    def port(cfg):
        return build_dataset(cfg, "cpu", rng, pyrng)

    got = port(dict(type="RepeatDataset", times=3, dataset=lab))
    _same_dataset(got, jax_wrappers.RepeatDataset(ref_lab, 3))
    assert got.dataset.device.type == "cpu" and got.dataset.rng is rng

    got = port(dict(type="ConcatDataset", datasets=[lab, unl]))
    want = jax_wrappers.ConcatDataset([ref_lab, ref_unl])
    _same_dataset(got, want)
    assert got.cumulative_sizes == want.cumulative_sizes
    assert [got._locate(i) for i in range(len(want))] == [
        want._locate(i) for i in range(len(want))]

    for thr in (0.3, 0.9):
        got = port(dict(type="ClassBalancedDataset", oversample_thr=thr,
                        dataset=unl))
        want = jax_wrappers.ClassBalancedDataset(ref_unl, thr)
        _same_dataset(got, want)
        assert got.indices == want.indices
        assert got.repeat_factors == want._repeat_factors(ref_unl, thr)
    assert len(got) > len(ref_unl)
