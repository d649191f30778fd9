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


if __name__ == "__main__":
    main()
