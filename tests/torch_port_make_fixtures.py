#!/usr/bin/env python3
"""Write the port's JPEG fixtures and their OpenCV decodes.

    python tests/torch_port_make_fixtures.py

Writes ``tests/torch_port_data/<name>.jpg`` with ``cv2.imwrite`` (baseline
JPEG, quality 90, 4:2:0 chroma for the colour ones, no EXIF block) and
``tests/torch_port_data/cv2_decodes.npz``: each file read back with
``cv2.imread(path, cv2.IMREAD_COLOR)`` (H, W, 3 uint8 BGR). For the
grayscale file that gives three equal channels, and the archive keeps one
of them, (H, W). Each decode is stored as its differences along a row
(modulo 256), which compress several times better than the pixels of
smooth content; :func:`load_decodes` sums them back and widens the
grayscale one again. The machine with the card has no OpenCV, so its
decoder is held against these committed decodes.

For the cut-JPEG fill, ``tests/torch_port_data/cut_fill_rows.json`` holds a
few integers per fixture: for each cut (bytes kept), the first row from
which ``cv2.imread`` of the cut file gives 128 in every channel to the
bottom. ``restart_640x427.jpg`` is the second fixture's decode written
again with a restart marker every 3 MCUs (``IMWRITE_JPEG_RST_INTERVAL``),
and ``progressive_640x427.jpg`` the same written progressive
(``IMWRITE_JPEG_PROGRESSIVE``), with its cut's numbers in the same file
(the first gray row and the mean |cut - whole| of OpenCV's decodes):
OpenCV keeps the earlier scans' coefficients there, so no row turns gray.

For the card's check of a cut progressive file,
``tests/torch_port_data/progressive_cuts.json`` holds, for each of
``PROGRESSIVE_CUTS`` (one cut in the DC scan, one in a later scan), the
bytes kept and the sha256 of the stream ``jpeg_scan.for_decoder`` hands
nvJPEG (the baseline transcode), and ``progressive_cut_means.npz`` the
4x4-pixel sums (uint16) of ``cv2.imread`` of each cut file. The CPU tests
hold ``cv2.imread`` of that stream equal to ``cv2.imread`` of the cut
file; the card holds nvJPEG's decode of it to the sums.

The content is smooth (low-frequency waves, gradients and a few soft
discs), seeded, at COCO-like landscape sizes; one file is grayscale.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "torch_port_data"
SEED = 0
# name -> (height, width, grayscale)
FIXTURES = {
    "coco_640x480": (480, 640, False),
    "coco_640x427": (427, 640, False),
    "coco_500x375": (375, 500, False),
    "gray_640x480": (480, 640, True),
}
RESTART, PROGRESSIVE = "restart_640x427", "progressive_640x427"
RESTART_INTERVAL = 3
CUT_FRACTIONS = (0.3, 0.6, 0.9)        # of the file's bytes, cuts kept
PROGRESSIVE_CUT = 0.5
PROGRESSIVE_CUTS = (0.12, 0.5)         # in the DC scan, in the fourth scan


def smooth_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 BGR: per channel a sum of a few long waves and a
    gradient, plus soft discs that give objects' edges to detect."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        acc = 110 + 40 * (xx / w) * rng.uniform(-1, 1) + 40 * (yy / h) * rng.uniform(-1, 1)
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            acc += 25 * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h) + rng.uniform(0, 6.3))
        img[..., c] = acc
    for _ in range(4):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        r = rng.uniform(0.08, 0.2) * min(h, w)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        alpha = np.clip((r - d) / 6.0, 0.0, 1.0)[..., None]
        img = img * (1 - alpha) + rng.uniform(20, 235, 3) * alpha
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def load_decodes() -> dict[str, np.ndarray]:
    """The committed cv2 decodes, each (H, W, 3) uint8 BGR."""
    out = {}
    with np.load(OUT / "cv2_decodes.npz") as f:
        for name, diffs in f.items():
            img = np.cumsum(diffs, axis=1, dtype=np.uint8)
            out[name] = np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
    return out


def gray_from(img: np.ndarray) -> int:
    """The first row from which ``img`` is 128 in every channel to the
    bottom (its height where the last row is not)."""
    gray = (img == 128).all(axis=tuple(range(1, img.ndim)))
    row = len(gray)
    while row and gray[row - 1]:
        row -= 1
    return row


def cut_fill_rows(tmp: Path) -> dict:
    """Per fixture, [cut, the first all-gray row of ``cv2.imread``] for each
    of ``CUT_FRACTIONS``; for the progressive one, its cut's gray row and
    the mean |cut - whole| of the two OpenCV decodes."""
    import cv2

    out, path = {}, tmp / "cut.jpg"
    for name in list(FIXTURES) + [RESTART, PROGRESSIVE]:
        data = (OUT / f"{name}.jpg").read_bytes()
        whole = cv2.imread(str(OUT / f"{name}.jpg"), cv2.IMREAD_COLOR)
        rows = []
        for frac in ((PROGRESSIVE_CUT,) if name == PROGRESSIVE else CUT_FRACTIONS):
            cut = int(len(data) * frac)
            path.write_bytes(data[:cut])
            img = cv2.imread(str(path), cv2.IMREAD_COLOR)
            rows.append([cut, gray_from(img)])
            if name == PROGRESSIVE:
                rows[-1].append(round(float(np.abs(
                    img.astype(np.int64) - whole).mean()), 4))
        out[name] = rows
    return out


def block_sums(img: np.ndarray) -> np.ndarray:
    """(H // 4, W // 4, C) uint16: the sum of each 4x4 block of pixels (the
    last rows and columns short of a block dropped)."""
    h, w = img.shape[0] // 4 * 4, img.shape[1] // 4 * 4
    return img[:h, :w].reshape(h // 4, 4, w // 4, 4, -1).astype(
        np.uint16).sum(axis=(1, 3), dtype=np.uint16)


def progressive_cuts(tmp: Path) -> tuple[list, dict]:
    """[cut, sha256 of ``for_decoder``'s stream] for each of
    ``PROGRESSIVE_CUTS``, and the 4x4 sums of ``cv2.imread`` of each cut
    file, keyed ``cut_<bytes>``."""
    import cv2
    import hashlib

    from dsl_tpu_torch.data.jpeg_scan import for_decoder

    data = (OUT / f"{PROGRESSIVE}.jpg").read_bytes()
    rows, sums, path = [], {}, tmp / "cut.jpg"
    for frac in PROGRESSIVE_CUTS:
        cut = int(len(data) * frac)
        rows.append([cut, hashlib.sha256(for_decoder(data[:cut])[0]).hexdigest()])
        path.write_bytes(data[:cut])
        sums[f"cut_{cut}"] = block_sums(cv2.imread(str(path), cv2.IMREAD_COLOR))
    return rows, sums


def write_progressive_cuts() -> None:
    import json
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        rows, sums = progressive_cuts(Path(tmp))
    (OUT / "progressive_cuts.json").write_text(json.dumps(rows, indent=1) + "\n")
    np.savez_compressed(OUT / "progressive_cut_means.npz", **sums)
    print(f"progressive_cuts.json: {rows}; progressive_cut_means.npz: "
          f"{(OUT / 'progressive_cut_means.npz').stat().st_size} bytes")


# PNG fixtures: name -> what it is. Each is written from a fixture's
# committed decode, cut to a small size; ``cv2.imwrite`` writes the types it
# can, :func:`encode_png` the rest (palette, gray with alpha, low-bit gray,
# tRNS, Adam7, every filter type).
PNG_SIZE = (72, 104)              # (h, w) of the crop each PNG is made from
PNG_FIXTURES = ("png_rgb8", "png_rgb16", "png_rgba8", "png_gray8",
                "png_gray16", "png_bilevel", "png_palette4_trns",
                "png_gray_alpha_adam7", "png_rgb8_adam7_filters",
                "png_gray2")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """PNG-filter rows of bytes (h, rowbytes): row ``y`` with type
    ``filters(y)``; each type is a function of the unfiltered bytes only."""
    out = []
    prior = np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[:len(row)]
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])[:len(row)]
        ftype = filters(y)
        pred = (0, left, prior, (left + prior) >> 1,
                _paeth(left, prior, upleft))[ftype]
        out.append(bytes([ftype]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, rowbytes) bytes at ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), flat.dtype)], 1)
    groups = flat.reshape(h, -1, per).astype(np.uint8)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(groups << shifts, axis=2).astype(np.uint8)


def png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(samples: np.ndarray, color_type: int, depth: int,
               interlace: bool = False, filters=None, palette=None,
               trns: bytes | None = None, idat_parts: int = 1) -> bytes:
    """A PNG of ``samples`` (h, w, channels of the colour type), written
    with the standard library: ``filters(y)`` gives each row's filter type
    (row index within its pass; by default y % 5, every type), ``palette``
    (n, 3) RGB, ``trns`` the tRNS chunk's body, the zlib stream split over
    ``idat_parts`` IDAT chunks. ``cv2.imwrite`` writes no interlaced,
    palette or low-bit gray file."""
    import struct
    import zlib

    filters = filters or (lambda y: y % 5)
    h, w = samples.shape[:2]
    bpp = max(1, samples.shape[2] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            stream += _filter_rows(_pack(sub, depth), bpp, filters)
    z = zlib.compress(stream, 9)
    cuts = np.linspace(0, len(z), idat_parts + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += png_chunk(b"IDAT", z[a:b])
    return out + png_chunk(b"IEND", b"")


def png_fixture_bytes(decodes: dict) -> dict[str, bytes]:
    """The PNG fixtures' bytes, from the committed decodes (the colour ones
    and the gray one cut to ``PNG_SIZE``)."""
    import cv2

    h, w = PNG_SIZE
    bgr = decodes["coco_640x480"][100:100 + h, 200:200 + w]
    gray = decodes["gray_640x480"][200:200 + h, 100:100 + w, 0]
    rng = np.random.RandomState(SEED)
    alpha = rng.randint(0, 256, (h, w), np.uint8)
    wide = bgr.astype(np.uint16) * 257 + rng.randint(0, 256, bgr.shape).astype(np.uint16)

    def imwrite(img, params=()):
        ok, buf = cv2.imencode(".png", img, list(params))
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        return buf.tobytes()

    rgb = bgr[..., ::-1]
    palette = rng.randint(0, 256, (12, 3))            # 12 of 16 entries
    index = (gray.astype(np.int64) * 17 // 256)[..., None]   # 0-16: some past 12
    return {
        "png_rgb8": imwrite(bgr),
        "png_rgb16": imwrite(wide),
        "png_rgba8": imwrite(np.dstack([bgr, alpha])),
        "png_gray8": imwrite(gray),
        "png_gray16": imwrite(gray.astype(np.uint16) * 257 + alpha),
        "png_bilevel": imwrite(gray, [cv2.IMWRITE_PNG_BILEVEL, 1]),
        "png_palette4_trns": encode_png(np.minimum(index, 15), 3, 4,
                                        palette=palette, trns=bytes(range(0, 240, 20))),
        "png_gray_alpha_adam7": encode_png(np.dstack([gray, alpha]), 4, 8,
                                           interlace=True),
        "png_rgb8_adam7_filters": encode_png(rgb, 2, 8, interlace=True,
                                             idat_parts=3),
        "png_gray2": encode_png((gray >> 6)[..., None], 0, 2),
    }


def write_png_fixtures() -> None:
    """Write ``tests/torch_port_data/<name>.png`` for ``PNG_FIXTURES``."""
    for name, data in png_fixture_bytes(load_decodes()).items():
        (OUT / f"{name}.png").write_bytes(data)
        print(f"{name}.png: {len(data)} bytes")


def main() -> None:
    import cv2
    import json
    import sys
    import tempfile

    sys.path.insert(0, str(OUT.parents[1]))      # the port, for for_decoder

    OUT.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(SEED)
    decodes = {}
    for name, (h, w, gray) in FIXTURES.items():
        img = smooth_image(rng, h, w)
        path = OUT / f"{name}.jpg"
        params = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
        if not cv2.imwrite(str(path), img, params):
            raise RuntimeError(f"cv2.imwrite failed for {path}")
        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if gray:
            if not (bgr == bgr[..., :1]).all():
                raise RuntimeError(f"{path}: cv2 gave unequal channels")
            bgr = bgr[..., 0]
        decodes[name] = np.diff(bgr, axis=1, prepend=np.uint8(0))
        print(f"{path.name}: {path.stat().st_size} bytes, decode {bgr.shape}")
    again = cv2.imread(str(OUT / "coco_640x427.jpg"), cv2.IMREAD_COLOR)
    for name, param, value in (
            (RESTART, cv2.IMWRITE_JPEG_RST_INTERVAL, RESTART_INTERVAL),
            (PROGRESSIVE, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)):
        cv2.imwrite(str(OUT / f"{name}.jpg"), again,
                    [cv2.IMWRITE_JPEG_QUALITY, 90, param, value])
    with tempfile.TemporaryDirectory() as tmp:
        rows = cut_fill_rows(Path(tmp))
    (OUT / "cut_fill_rows.json").write_text(json.dumps(rows, indent=1) + "\n")
    print(f"cut_fill_rows.json: {rows}")
    write_progressive_cuts()
    np.savez_compressed(OUT / "cv2_decodes.npz", **decodes)
    print(f"cv2_decodes.npz: {(OUT / 'cv2_decodes.npz').stat().st_size} bytes")
    for name, img in load_decodes().items():
        want = cv2.imread(str(OUT / f"{name}.jpg"), cv2.IMREAD_COLOR)
        if not np.array_equal(img, want):
            raise RuntimeError(f"{name}: the stored decode does not read back")
    write_png_fixtures()


if __name__ == "__main__":
    main()
