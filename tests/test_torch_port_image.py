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
  chunks, and the same label files, the skipped ones untouched;
- a JPEG cut inside its entropy-coded data: ``jpeg_scan.cut_fill_row``
  gives the first row of ``cv2.imread``'s gray fill exactly, for cuts
  through the fixtures and copies written here with each chroma layout,
  restart markers and gray content; the stream completed for nvJPEG
  decodes (by OpenCV here) to the cut file's rows above the band the data
  ends in and to gray from the fill row, and in every row to the cut
  file's decode; the committed fill rows the card is held to are OpenCV's;
- a progressive JPEG cut anywhere in its scans: ``cv2.imread`` of the
  baseline transcode ``jpeg_scan.for_decoder`` gives (``jpeg_coef``:
  libjpeg's coefficients with its interblock smoothing) equals
  ``cv2.imread`` of the cut file bit for bit, for files written here
  (OpenCV at 4:2:0, 4:4:4 and grayscale, with restart markers, Pillow) and
  the committed fixture, cut in the DC scan, at every scan boundary, in
  each of the first three AC scans and inside a stuffed ``FF 00``; the
  committed transcodes the card decodes are these.
"""

import hashlib
import io
import json
import struct
import types

import cv2
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.train import label_store as jax_store
from dsl_tpu.train.semi import PseudoLabelRefresher as JaxRefresher
from dsl_tpu_torch.data import image_io, jpeg_coef, jpeg_scan
from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size
from dsl_tpu_torch.train import label_store
from dsl_tpu_torch.train.semi import PseudoLabelRefresher
from torch_port_make_fixtures import (
    FIXTURES, OUT, PROGRESSIVE, RESTART, block_sums, cut_fill_rows, gray_from,
    progressive_cuts, smooth_image)

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


# the layouts written here from the second fixture's decode: each chroma
# subsampling OpenCV writes, restart markers, and colour files of gray
# content (their chroma is 128, so nothing bleeds into the band below)
LAYOUTS = {f"sampling_{f}": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{f}")]
           for f in ("411", "420", "422", "440", "444")}
LAYOUTS.update(restart_2=[cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
               restart_7=[cv2.IMWRITE_JPEG_RST_INTERVAL, 7],
               gray_content_420=[], gray_content_440=[
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
CUTS = np.linspace(0.2, 0.95, 8)


def _jpeg(layout: str) -> bytes:
    if layout in FIXTURES:
        return (OUT / f"{layout}.jpg").read_bytes()
    img = cv2.imread(str(OUT / "coco_640x427.jpg"), cv2.IMREAD_COLOR)
    if layout.startswith("gray_content"):
        img = cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY),
                           cv2.COLOR_GRAY2BGR)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         *LAYOUTS[layout]])
    assert ok
    return buf.tobytes()


def _band(layout: str) -> int:
    """The iMCU row's height: 16 where the chroma is subsampled vertically
    (4:2:0, OpenCV's default, and 4:4:0), else 8."""
    gray = layout == "gray_640x480"
    return 16 if not gray and ("420" in layout or "440" in layout or not any(
        f in layout for f in ("411", "422", "444"))) else 8


def _cv2_cut(data: bytes, path) -> np.ndarray:
    path.write_bytes(data)
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert img is not None
    return img


def _cuts(data: bytes) -> list[int]:
    """8 cuts from 20% to 95% of the file, and 1 and 3 bytes past the scan
    header's component selectors (inside its spectral bytes)."""
    end = image_io.jpeg_header_end(data)
    return sorted({end + 1, end + 3} | {int(len(data) * f) for f in CUTS})


@pytest.mark.parametrize("layout", sorted(FIXTURES) + sorted(LAYOUTS))
def test_truncated_imcu_row_is_cv2s_fill(layout, tmp_path):
    """For every cut, the scan's fill row is the first row from which
    ``cv2.imread`` gives 128 in every channel to the bottom, one or two
    rows below the band the data ends in; the whole file is not cut."""
    data = _jpeg(layout)
    assert jpeg_scan.cut_fill_row(data) is None
    assert jpeg_scan.truncated_imcu_row(data) is None
    seen = set()
    for cut in _cuts(data):
        img = _cv2_cut(data[:cut], tmp_path / "cut.jpg")
        want = gray_from(img)
        got = jpeg_scan.cut_fill_row(data[:cut])
        assert (img.shape[0] if got is None else got) == want, cut
        k = jpeg_scan.truncated_imcu_row(data[:cut])
        if got is not None:
            assert got - (k + 1) * _band(layout) in (0, 1), (cut, k, got)
            seen.add(got - (k + 1) * _band(layout))
        # the stream the card route decodes is the cut file's, every row
        np.testing.assert_array_equal(_cv2_cut(jpeg_scan.for_decoder(
            data[:cut])[0], tmp_path / "whole.jpg"), img, err_msg=str(cut))
    # the bleed row: only where the chroma is subsampled vertically and
    # not gray (early cuts leave the band's chroma at 128 too)
    if "gray_content" in layout or _band(layout) == 8:
        assert seen == {0}
    else:
        assert 1 in seen


@pytest.mark.parametrize("layout", ["coco_640x480", "gray_640x480",
                                    "sampling_422", "restart_2", "restart_7"])
def test_completed_stream_keeps_the_rows_before_the_cut(layout, tmp_path):
    """The stream the card route hands nvJPEG is whole (ends in EOI), and
    decoded by OpenCV it gives the cut file's decode in every row above the
    band the data ends in (and its bleed row), and gray from the fill
    row."""
    data = _jpeg(layout)
    for cut in _cuts(data):
        stream, fill = jpeg_scan.for_decoder(data[:cut])
        assert stream.endswith(b"\xff\xd9") and stream != data[:cut]
        assert fill == jpeg_scan.cut_fill_row(data[:cut])
        want = _cv2_cut(data[:cut], tmp_path / "cut.jpg")
        got = _cv2_cut(stream, tmp_path / "whole.jpg")
        k = jpeg_scan.truncated_imcu_row(data[:cut])
        band = _band(layout)
        keep = max(0, k * band - (band == 16))
        np.testing.assert_array_equal(got[:keep], want[:keep], err_msg=str(cut))
        if fill is not None:
            assert (got[fill:] == 128).all(), cut
    assert jpeg_scan.for_decoder(data) == (data, None)


# progressive files written here from seeds, small (the host decode is
# pure Python): name -> (height, width, writer, options)
PROGRESSIVE_FILES = {
    "cv2_420": (72, 101, "cv2", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "cv2_444": (64, 90, "cv2", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "cv2_gray": (96, 150, "cv2", []),
    "cv2_restart": (64, 96, "cv2", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "pillow": (70, 99, "pillow", []),
}
CUT_KINDS = ("dc_scan", "scan_boundaries", "ac_scans", "stuffed")


def _progressive(name: str) -> bytes:
    if name == PROGRESSIVE:
        return (OUT / f"{name}.jpg").read_bytes()
    import PIL.Image

    h, w, writer, options = PROGRESSIVE_FILES[name]
    img = smooth_image(np.random.RandomState(sorted(PROGRESSIVE_FILES).index(name)),
                       h, w)
    if name == "cv2_gray":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if writer == "pillow":
        buf = io.BytesIO()
        PIL.Image.fromarray(img[..., ::-1]).save(buf, "JPEG", quality=85,
                                                 progressive=True)
        return buf.getvalue()
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *options])
    assert ok
    return buf.tobytes()


def _scans(data: bytes) -> list[tuple[int, int, int]]:
    """(start of the SOS marker, start of the entropy-coded data, start of
    the marker after it) of each scan."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if data[pos + 1] != 0xDA:
            pos += 2 + length
            continue
        start = end = pos + 2 + length
        while data[end] != 0xFF or data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
            end += 1
        out.append((pos, start, end))
        pos = end
    return out


def _progressive_cuts(data: bytes, kind: str) -> list[int]:
    scans = _scans(data)
    if kind == "dc_scan":
        return [(scans[0][1] + scans[0][2]) // 2, scans[0][1] + 1]
    if kind == "scan_boundaries":
        # the SOS present with no entropy-coded byte, and the data ending
        # just before the marker after a scan
        return sorted({c for _, start, end in scans for c in (start, end)})
    if kind == "ac_scans":
        return [a + (b - a) * f // 3 for _, a, b in scans[1:4] for f in (1, 2)]
    stuffed = [i for _, a, b in scans for i in range(a, b - 1)
               if data[i] == 0xFF and data[i + 1] == 0]
    return [stuffed[0] + 1, stuffed[len(stuffed) // 2] + 1]


@pytest.mark.parametrize("kind", CUT_KINDS)
@pytest.mark.parametrize("name", sorted(PROGRESSIVE_FILES) + [PROGRESSIVE])
def test_progressive_cut_is_cv2s(name, kind, tmp_path):
    """``cv2.imread`` of the stream the card route hands nvJPEG for a cut
    progressive file (a whole baseline JPEG, nothing filled) equals
    ``cv2.imread`` of the cut file, bit for bit, every row."""
    data = _progressive(name)
    assert data[2:].find(b"\xff\xc2") >= 0
    cuts = _progressive_cuts(data, kind)
    assert cuts
    for cut in cuts:
        stream, fill = jpeg_scan.for_decoder(data[:cut])
        assert fill is None and stream.endswith(b"\xff\xd9"), cut
        assert stream.find(b"\xff\xc0") >= 0, cut          # baseline
        np.testing.assert_array_equal(
            _cv2_cut(stream, tmp_path / "whole.jpg"),
            _cv2_cut(data[:cut], tmp_path / "cut.jpg"), err_msg=str(cut))


def test_progressive_smoothing_fills_what_a_cut_lacks(tmp_path):
    """Cut in the DC scan, OpenCV's decode is not flat within a block: the
    transcode carries AC coefficients libjpeg estimated (its interblock
    smoothing), not only the received ones; a whole file is handed on as
    it is, and so is one cut inside a segment's header (not covered)."""
    data = _progressive(PROGRESSIVE)
    cut = _progressive_cuts(data, "dc_scan")[0]
    img = _cv2_cut(jpeg_scan.for_decoder(data[:cut])[0], tmp_path / "t.jpg")
    blocks = img[:424].reshape(53, 8, 80, 8, 3).astype(int)
    spread = blocks.max(axis=(1, 3)) - blocks.min(axis=(1, 3))
    assert (spread > 0).mean() > 0.5
    assert jpeg_coef.transcode(data) is None
    assert jpeg_scan.for_decoder(data) == (data, None)
    inside = _scans(data)[1][0] + 6          # inside the second SOS header
    assert jpeg_scan.for_decoder(data[:inside]) == (data[:inside], None)


def test_committed_progressive_cuts_are_cv2s(tmp_path):
    """The transcodes the card decodes (their sha256) and OpenCV's decodes
    of the cut files (4x4 sums) are committed as the fixture maker writes
    them, and OpenCV decodes each transcode as the cut file."""
    committed = json.loads((OUT / "progressive_cuts.json").read_text())
    rows, sums = progressive_cuts(tmp_path)
    assert rows == committed
    with np.load(OUT / "progressive_cut_means.npz") as f:
        assert sorted(f) == sorted(sums)
        for key in f:
            np.testing.assert_array_equal(f[key], sums[key])
    data = _progressive(PROGRESSIVE)
    for cut, sha in committed:
        stream, _ = jpeg_scan.for_decoder(data[:cut])
        assert hashlib.sha256(stream).hexdigest() == sha
        np.testing.assert_array_equal(
            block_sums(_cv2_cut(stream, tmp_path / "t.jpg")), sums[f"cut_{cut}"])


def test_committed_fill_rows_are_cv2s(tmp_path):
    """The fill rows the card's test reads are OpenCV's, and the scan's."""
    committed = json.loads((OUT / "cut_fill_rows.json").read_text())
    assert cut_fill_rows(tmp_path) == committed
    for name, rows in committed.items():
        data = (OUT / f"{name}.jpg").read_bytes()
        for cut, gray, *_ in rows:
            got = jpeg_scan.cut_fill_row(data[:cut])
            if name != PROGRESSIVE:
                assert got == gray, (name, cut)
    assert RESTART in committed
