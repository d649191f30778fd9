"""The port's PNG reader (``dsl_tpu_torch/data/png.py``) against
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0 over libpng 1.6).

- Every colour type (0, 2, 3, 4, 6) at each of its bit depths (1, 2, 4,
  8, 16), with and without tRNS, plain and Adam7, each row filter type
  forced in turn, at sizes 3x5 and 9x17, written by the small encoder in
  ``tests/torch_port_make_fixtures.py`` (``cv2.imwrite`` writes no
  interlaced, palette or low-bit gray file); and the committed fixtures
  (``PNG_FIXTURES``, mostly ``cv2.imwrite``'s): the CPU route's tensor
  equals ``cv2.imread``'s image bit for bit, and so does ``read_image``.
- ``readable`` is ``cv2.imread(...) is not None`` at every cut of every
  committed fixture (the largest, ``png_rgb16``, is ``slow``;
  ``cv2.imdecode`` of the cut bytes, which gives
  ``cv2.imread``'s answer: held on every cut of the four smallest through
  a file), a file that lacks only its IEND chunk included; and on damaged
  files: each byte of the smallest fixtures flipped (a chunk length, name,
  body or CRC; IEND's CRC, which OpenCV does not read; the palette
  fixture's flips are ``slow``), a damaged zlib
  stream under a good CRC (in its Adler-32 too: libpng reads the stream
  to its end), a stream without its Adler-32 or final block, bytes past
  the stream's end and rows past the image (both read), an ancillary
  chunk with a bad CRC (dropped, the image read), an unknown critical
  chunk.
- The numpy plain unfilter equals a direct per-byte loop of the PNG
  specification's filters on every fixture.
- The refresher skips a PNG without its IEND chunk, as the JAX package's
  does (the same chunks, the same label files).

Tolerance: none.
"""

import json
import struct
import types
import zlib

import cv2
import numpy as np
import pytest
import torch

from dsl_tpu.train import label_store as jax_store
from dsl_tpu.train.semi import PseudoLabelRefresher as JaxRefresher
from dsl_tpu_torch.data import png
from dsl_tpu_torch.data.image_io import read_image, readable
from dsl_tpu_torch.train import label_store
from dsl_tpu_torch.train.semi import PseudoLabelRefresher
from torch_port_make_fixtures import (
    FIXTURES, OUT, PNG_FIXTURES, encode_png, png_chunk)

torch.set_num_threads(2)

SMALLEST = ("png_bilevel", "png_gray2", "png_palette4_trns", "png_gray8")


def _imread(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)


def _imdecode(data: bytes):
    if not data:
        return None
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _assert_is_cv2(data: bytes, path, label):
    path.write_bytes(data)
    want = _imread(path)
    assert png.readable(data) == (want is not None), label
    if want is not None:
        got = png.decode(data, "cpu")
        assert got.dtype == torch.uint8 and got.shape == want.shape, label
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(label))


COMBOS = [(ct, d) for ct, depths in png.BIT_DEPTHS.items() for d in depths]


@pytest.mark.parametrize("ct,depth", COMBOS,
                         ids=[f"type{ct}_depth{d}" for ct, d in COMBOS])
def test_every_layout_is_cv2(ct, depth, tmp_path):
    rng = np.random.RandomState(10 * ct + depth)
    channels = png.CHANNELS[ct]
    for h, w in ((3, 5), (9, 17)):
        samples = rng.randint(0, 1 << depth, (h, w, channels))
        palette = (rng.randint(0, 256, (min(1 << depth, 256) - 1, 3))
                   if ct == 3 else None)           # the top index past it
        trns_options = [None]
        if ct == 0:
            trns_options.append(struct.pack(">H", int(samples[0, 0, 0])))
        elif ct == 2:
            trns_options.append(struct.pack(">HHH", *map(int, samples[0, 0])))
        elif ct == 3:
            trns_options.append(bytes(range(0, 200, 40)))
        for interlace in (False, True):
            for trns in trns_options:
                for ftype in range(5):
                    data = encode_png(samples, ct, depth, interlace=interlace,
                                      filters=lambda y, f=ftype: f,
                                      palette=palette, trns=trns)
                    _assert_is_cv2(data, tmp_path / "x.png",
                                   (h, w, interlace, trns, ftype))


@pytest.mark.parametrize("name", PNG_FIXTURES)
def test_fixture_is_cv2(name):
    path = OUT / f"{name}.png"
    want = _imread(path)
    assert want is not None
    np.testing.assert_array_equal(read_image(path, "cpu").numpy(), want)
    assert readable(path, "cpu")


# libpng inflates rows before it finds a cut past the first IDAT chunk:
# the largest fixture's 34 470 cuts take about 7 s through OpenCV
EVERY_CUT = [pytest.param(n, marks=pytest.mark.slow) if n == "png_rgb16" else n
             for n in PNG_FIXTURES]


@pytest.mark.parametrize("name", EVERY_CUT)
def test_readable_is_cv2_at_every_cut(name, tmp_path):
    data = (OUT / f"{name}.png").read_bytes()
    through_file = name in SMALLEST
    for cut in range(len(data) + 1):
        part = data[:cut]
        want = _imdecode(part) is not None
        if through_file:
            (tmp_path / "cut.png").write_bytes(part)
            assert (_imread(tmp_path / "cut.png") is not None) == want, cut
        assert png.readable(part) == want, cut
    assert not png.readable(data[:-12]) and png.readable(data)


@pytest.mark.parametrize("name", [
    "png_bilevel", "png_gray2",
    pytest.param("png_palette4_trns", marks=pytest.mark.slow)])
def test_every_flipped_byte_is_cv2(name, tmp_path):
    data = (OUT / f"{name}.png").read_bytes()
    for pos in range(len(data)):
        for flip in (0x01, 0x80):
            bad = bytearray(data)
            bad[pos] ^= flip
            _assert_is_cv2(bytes(bad), tmp_path / "x.png", (pos, flip))


def _with_chunk_after_ihdr(data: bytes, chunk: bytes) -> bytes:
    return data[:33] + chunk + data[33:]


def test_damaged_files_are_cv2(tmp_path):
    data = (OUT / "png_rgb8.png").read_bytes()
    i = data.index(b"IDAT") - 4
    n = struct.unpack_from(">I", data, i)[0]
    body = bytearray(data[i + 8:i + 8 + n])
    cases = {}
    for at in (2, 40, len(body) // 2, len(body) - 6, len(body) - 2):
        damaged = bytearray(body)
        damaged[at] ^= 0x5A
        cases[f"zlib_{at}_good_crc"] = (data[:i] + png_chunk(b"IDAT", bytes(damaged))
                                        + data[i + 12 + n:])
        cases[f"zlib_{at}_bad_crc"] = (data[:i + 8] + bytes(damaged)
                                       + data[i + 8 + n:])
    text = png_chunk(b"tEXt", b"Comment\x00hello")
    cases["ancillary_bad_crc"] = _with_chunk_after_ihdr(
        data, text[:-1] + bytes([text[-1] ^ 1]))
    cases["ancillary_after_idat"] = data[:-12] + text + data[-12:]
    cases["unknown_critical"] = _with_chunk_after_ihdr(
        data, png_chunk(b"ABCD", b"xyz"))
    cases["no_iend"] = data[:-12]
    cases["iend_bad_crc"] = data[:-1] + bytes([data[-1] ^ 0xFF])
    cases["trailing_bytes"] = data + b"junk"
    cases["stream_too_short"] = (data[:i] + png_chunk(
        b"IDAT", zlib.compress(zlib.decompress(bytes(body))[:-50]))
        + data[i + 12 + n:])
    raw = zlib.decompress(bytes(body))
    flush = zlib.compressobj(9)
    for label, stream in (
            ("stream_no_adler", bytes(body[:-4])),
            ("stream_not_final", flush.compress(raw) + flush.flush(zlib.Z_SYNC_FLUSH)),
            ("stream_then_bytes", bytes(body) + b"\x00\x01\x02"),
            ("stream_too_long", zlib.compress(raw + bytes(100), 9))):
        cases[label] = (data[:i] + png_chunk(b"IDAT", stream)
                        + data[i + 12 + n:])
    readable_cases = set()
    for label, case in cases.items():
        _assert_is_cv2(case, tmp_path / "x.png", label)
        if png.readable(case):
            readable_cases.add(label)
    assert {"ancillary_bad_crc", "ancillary_after_idat", "iend_bad_crc",
            "trailing_bytes", "stream_then_bytes", "stream_too_long"
            } <= readable_cases
    assert not {"no_iend", "unknown_critical", "stream_too_short",
                "stream_no_adler", "stream_not_final", "zlib_2_good_crc",
                "zlib_40_bad_crc", f"zlib_{len(body) - 2}_good_crc"
                } & readable_cases


def _unfilter_by_spec(image: png.PngImage) -> np.ndarray:
    """The PNG specification's filters byte by byte, in plain Python."""
    out = bytearray()
    raw, bpp, pos = image.filtered, image.bpp, 0
    for *_, w, h in image.passes:
        rb = image.rowbytes(w)
        prev = [0] * rb
        for _ in range(h):
            ftype, line = raw[pos], raw[pos + 1:pos + 1 + rb]
            pos += 1 + rb
            cur = [0] * rb
            for x in range(rb):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                else:
                    pred = (0, a, b, (a + b) // 2)[ftype]
                cur[x] = (line[x] + pred) & 255
            out += bytes(cur)
            prev = cur
    return np.frombuffer(bytes(out), np.uint8)


@pytest.mark.parametrize("name", ["png_rgb8_adam7_filters", "png_gray16",
                                  "png_palette4_trns", "png_gray2"])
def test_plain_unfilter_is_the_specification(name):
    image = png.parse((OUT / f"{name}.png").read_bytes())
    np.testing.assert_array_equal(png.unfilter_reference(image),
                                  _unfilter_by_spec(image))


def _zeros(n):
    return (np.zeros((n, 100, 5), np.float32), np.zeros((n, 100), np.int64),
            np.zeros((n, 100), bool))


def test_refresh_skips_a_cut_png_as_jax(tmp_path):
    """Three PNG fixtures, a JPEG fixture and a PNG without its IEND chunk
    at ``refresh_batch`` 2: both refreshers cut the same chunks; predicting
    nothing, both write the same (empty) label files for the readable
    files and leave the cut one's as it was."""
    images = tmp_path / "images"
    images.mkdir()
    good = []
    for name in ("png_rgb8", "png_gray_alpha_adam7", "png_palette4_trns"):
        (images / f"{name}.png").write_bytes((OUT / f"{name}.png").read_bytes())
        good.append(f"{name}.png")
    jpeg = sorted(FIXTURES)[0] + ".jpg"
    (images / jpeg).write_bytes((OUT / jpeg).read_bytes())
    good.insert(1, jpeg)
    cut = "cut.png"
    (images / cut).write_bytes((OUT / "png_rgb8.png").read_bytes()[:-12])
    names = good[:2] + [cut] + good[2:]
    infos = [dict(filename=n, height=1, width=1) for n in names]
    cat = dict(id2cat={"0": "cat"}, cat2id={"cat": 0})
    args = dict(canvas_hw=(64, 96), img_scale=(96, 64), refresh_batch=2)
    stores = {tag: mod.LabelStore(str(tmp_path / tag), cat["id2cat"],
                                  cat["cat2id"])
              for tag, mod in (("jax", jax_store), ("port", label_store))}
    for store in stores.values():
        for n in names:
            store.write(n, [[1.0, 2.0, 30.0, 40.0]], ["cat"], [0.9])
    before = (tmp_path / "port" / f"{cut}.json").read_bytes()

    ref = JaxRefresher(None, stores["jax"], str(images), infos, **args)
    ref._get_copy_fn = lambda: (lambda v: v)
    ref._get_predict = lambda: (lambda v, u8, sh, sf: _zeros(len(u8)))
    jax_chunks = [n for n, _ in ref._prep_and_dispatch(None, names)]
    ref.refresh_images(types.SimpleNamespace(teacher_variables=None), names)

    port = PseudoLabelRefresher(torch.nn.Identity(), stores["port"],
                                str(images), infos, device="cpu", **args)
    port._predict_chunk = lambda params, chunk: [
        (0, *map(torch.from_numpy, _zeros(args["refresh_batch"])))]
    port_chunks = [n for n, _ in port._predict_all({}, names)]
    port.refresh_images(types.SimpleNamespace(teacher_params={}), names)

    assert port_chunks == jax_chunks == [good[:2], good[2:]]
    for n in names:
        got = (tmp_path / "port" / f"{n}.json").read_bytes()
        assert got == (tmp_path / "jax" / f"{n}.json").read_bytes(), n
        if n == cut:
            assert got == before
        else:
            assert json.loads(got)["targetNum"] == 0, n
