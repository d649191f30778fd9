"""The port's image reading and resizing against OpenCV, on the CPU.

- ``image_ops.resize_linear_u8`` equals ``cv2.resize(INTER_LINEAR)`` bit
  for bit: a seeded sweep of sizes (up, down, exact halves, one pixel wide
  or high, the identity) and the JPEG fixtures at the flagship's and the
  baseline's scales;
- ``image_io.readable`` says whether ``cv2.imread`` gives an image, for
  every cut of each fixture through its header and a few past it, and for
  an empty file, a missing one, SOI followed by garbage and a PNG;
- ``image_io.exif_orientation`` and ``apply_orientation`` on a tensor give
  what ``cv2.imread`` gives for a fixture the test tags with each
  orientation 1-8 in both byte orders, and leave the image as decoded
  where the segment is malformed, as OpenCV does;
- ``PseudoLabelRefresher`` drops the files ``cv2.imread`` cannot read
  before it cuts the list into chunks, as the JAX refresher does: the same
  chunks, and the same label files, the skipped ones untouched.
"""

import json
import types

import cv2
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.train import label_store as jax_store
from dsl_tpu.train.semi import PseudoLabelRefresher as JaxRefresher
from dsl_tpu_torch.data import image_io
from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size
from dsl_tpu_torch.train import label_store
from dsl_tpu_torch.train.semi import PseudoLabelRefresher
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

RNG = np.random.RandomState(0)
# (h, w) -> (new_h, new_w)
SIZES = [((480, 640), (800, 1067)), ((375, 500), (800, 1067)),
         ((7, 9), (800, 1029)), ((480, 640), (240, 320)),
         ((800, 1200), (400, 600)), ((60, 90), (120, 180)), ((1, 1), (5, 7)),
         ((1, 7), (3, 2)), ((7, 1), (2, 3)), ((33, 45), (33, 45)),
         ((2, 2), (1, 1))] + [
    (tuple(RNG.randint(1, 90, 2)), tuple(RNG.randint(1, 180, 2)))
    for _ in range(12)]
# the flagship's train scales and the baseline's (the same two), and the
# test pipelines' (1333, 800)
SCALES = [(1333, 640), (1333, 800)]


def _cv2_resize(img, nh, nw):
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR).reshape(
        nh, nw, img.shape[2])


@pytest.mark.parametrize("case", range(len(SIZES)))
def test_resize_linear_u8_is_cv2(case):
    (h, w), (nh, nw) = SIZES[case]
    img = np.random.RandomState(case).randint(0, 256, (h, w, 3)).astype(np.uint8)
    got = resize_linear_u8(torch.from_numpy(img), nh, nw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _cv2_resize(img, nh, nw))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_resize_linear_u8_is_cv2_on_the_fixtures(name):
    img = cv2.imread(str(OUT / f"{name}.jpg"), cv2.IMREAD_COLOR)
    for scale in SCALES:
        nh, nw = keep_ratio_size(*img.shape[:2], scale)
        got = resize_linear_u8(torch.from_numpy(img), nh, nw).numpy()
        np.testing.assert_array_equal(got, _cv2_resize(img, nh, nw),
                                      err_msg=str(scale))


def test_resize_linear_u8_refuses_float():
    with pytest.raises(TypeError):
        resize_linear_u8(torch.zeros(4, 4, 3), 2, 2)


def _cv2_reads(path) -> bool:
    return cv2.imread(str(path), cv2.IMREAD_COLOR) is not None


@pytest.mark.parametrize("first_read", [image_io.PROBE_FIRST_READ, 64])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_readable_is_cv2_across_the_header(name, first_read, tmp_path,
                                           monkeypatch):
    """Every cut from 0 bytes to 40 past the end of the first scan header's
    component selectors, and the half and the whole file; with the probe's
    first read as it is (the whole of a short cut, a prefix of the rest) and
    cut to 64 bytes (the header read in doublings)."""
    monkeypatch.setattr(image_io, "PROBE_FIRST_READ", first_read)
    data = (OUT / f"{name}.jpg").read_bytes()
    end = image_io.jpeg_header_end(data)
    assert end is not None
    path = tmp_path / "cut.jpg"
    seen = set()
    for cut in list(range(end + 40)) + [len(data) // 2, len(data)]:
        path.write_bytes(data[:cut])
        want = _cv2_reads(path)
        assert image_io.readable(path, "cpu") == want, cut
        seen.add(want)
    assert seen == {False, True}


def test_readable_is_cv2_on_unreadable_files(tmp_path):
    data = (OUT / "coco_640x480.jpg").read_bytes()
    files = U.unreadable_files(tmp_path, data)
    for name, path in files.items():
        assert not _cv2_reads(path), name
        assert not image_io.readable(path, "cpu"), name
    png = tmp_path / "a.png"
    cv2.imwrite(str(png), np.zeros((8, 8, 3), np.uint8))
    assert _cv2_reads(png) and image_io.readable(png, "cpu")
    assert image_io.readable(OUT / "coco_640x480.jpg", "cpu")


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_cv2(orientation, order, tmp_path):
    name = "coco_500x375"
    data = (OUT / f"{name}.jpg").read_bytes()
    path = tmp_path / "tagged.jpg"
    path.write_bytes(U.with_exif(data, U.exif_segment(orientation, order)))
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    raw = cv2.imread(str(path), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    tag = image_io.exif_orientation(path.read_bytes())
    assert tag == orientation
    got = image_io.apply_orientation(torch.from_numpy(raw), tag)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(U.orient_like_cv2(raw, orientation), want)


# malformed segments and the orientation OpenCV 5.0 reads from each: none
# (1), or the tag where it comes before the fault (an IFD0 that claims more
# entries than it holds) or in the low half of a 32-bit little-endian value
MALFORMED = {
    "value_0": (dict(orientation=0), 1),
    "value_9": (dict(orientation=9), 1),
    "bad_tiff_magic": (dict(orientation=6, tiff_magic=b"XX*\x00"), 1),
    "no_entries": (dict(orientation=6, n_entries=0), 1),
    "entries_past_the_end": (dict(orientation=6, n_entries=40), 6),
    "long_big_endian": (dict(orientation=6, order="MM", value_type=4), 1),
    "long_little_endian": (dict(orientation=6, order="II", value_type=4), 6),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_exif_is_read_as_cv2_reads_it(case, tmp_path):
    kwargs, tag = MALFORMED[case]
    data = (OUT / "coco_500x375.jpg").read_bytes()
    path = tmp_path / "tagged.jpg"
    path.write_bytes(U.with_exif(data, U.exif_segment(**kwargs)))
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    raw = cv2.imread(str(path), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    assert image_io.exif_orientation(path.read_bytes()) == tag
    got = image_io.apply_orientation(torch.from_numpy(raw), tag)
    np.testing.assert_array_equal(got.numpy(), want)


def _zeros(n):
    return (np.zeros((n, 100, 5), np.float32), np.zeros((n, 100), np.int64),
            np.zeros((n, 100), bool))


def test_refresh_skips_unreadable_files_as_jax(tmp_path):
    """Four good fixtures and the four unreadable files interleaved, at
    ``refresh_batch`` 3: both refreshers cut the readable files into the
    same chunks; predicting nothing, both write the same (empty) label
    files for the good ones and leave the unreadable ones' as they were."""
    images = tmp_path / "images"
    images.mkdir()
    good = []
    for n in sorted(FIXTURES):
        (images / f"{n}.jpg").write_bytes((OUT / f"{n}.jpg").read_bytes())
        good.append(f"{n}.jpg")
    bad = [p.name for p in U.unreadable_files(
        images, (OUT / "coco_640x480.jpg").read_bytes()).values()]
    names = [x for pair in zip(good, bad) for x in pair]
    infos = [dict(filename=n, height=1, width=1) for n in names]
    cat = dict(id2cat={"0": "cat"}, cat2id={"cat": 0})
    args = dict(canvas_hw=(64, 96), img_scale=(96, 64), refresh_batch=3)

    stores = {tag: mod.LabelStore(str(tmp_path / tag), cat["id2cat"],
                                  cat["cat2id"])
              for tag, mod in (("jax", jax_store), ("port", label_store))}
    for store in stores.values():
        for n in names:
            store.write(n, [[1.0, 2.0, 30.0, 40.0]], ["cat"], [0.9])
    before = {n: (tmp_path / "port" / f"{n}.json").read_bytes() for n in bad}

    ref = JaxRefresher(None, stores["jax"], str(images), infos, **args)
    ref._get_copy_fn = lambda: (lambda v: v)
    ref._get_predict = lambda: (lambda v, u8, sh, sf: _zeros(len(u8)))
    jax_chunks = [names_ for names_, _ in ref._prep_and_dispatch(None, names)]
    ref.refresh_images(types.SimpleNamespace(teacher_variables=None), names)

    port = PseudoLabelRefresher(torch.nn.Identity(), stores["port"],
                                str(images), infos, device="cpu", **args)
    port._predict_chunk = lambda params, chunk: [
        (0, *map(torch.from_numpy, _zeros(args["refresh_batch"])))]
    port_chunks = [names_ for names_, _ in port._predict_all({}, names)]
    port.refresh_images(types.SimpleNamespace(teacher_params={}), names)

    assert port_chunks == jax_chunks == [good[:3], good[3:]]
    for n in names:
        got = (tmp_path / "port" / f"{n}.json").read_bytes()
        assert got == (tmp_path / "jax" / f"{n}.json").read_bytes(), n
        if n in bad:
            assert got == before[n], n
        else:
            assert json.loads(got)["targetNum"] == 0, n
