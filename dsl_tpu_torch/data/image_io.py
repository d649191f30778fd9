"""Read an image file into a (H, W, 3) uint8 BGR tensor on a device.

Counterpart of ``cv2.imread(path, cv2.IMREAD_COLOR)`` in
``dsl_tpu/data/pipelines/loading.py::LoadImageFromFile``. Two routes, chosen
by the device and by nothing else:

- CUDA: the file's bytes go to nvJPEG (``csrc/nvjpeg_decode.cu``, built at
  first use), which decodes on the current stream into a tensor the caching
  allocator owns. JPEG only: another format raises and names it. nvJPEG
  applies no EXIF orientation, so the Orientation tag is read here on the
  host (:func:`exif_orientation`) and applied to the decoded tensor as
  OpenCV applies it (:func:`apply_orientation`). nvJPEG rounds its IDCT and
  upsamples chroma its own way, so pixels part from OpenCV's by a few levels
  (``chip_smoke.py`` measures it on the card).
- CPU: ``cv2.imread`` with ``IMREAD_COLOR``, imported here, as the JAX
  package reads. A grayscale file gives three equal channels on both
  routes.

A PNG takes neither: both routes read it with ``data/png.py`` (zlib and
the row filters on the host, the colour rules on the tensor's device), bit
for bit ``cv2.imread``'s image; the card route unfilters with the host C
function and uploads once. Other formats OpenCV reads (BMP, TIFF, WebP)
raise on the card route, naming the format.

:func:`readable` tells, without decoding, whether ``cv2.imread`` would give
an image, so a caller can skip a file as the JAX package skips one that
``cv2.imread`` cannot read.

A JPEG cut inside its entropy-coded data decodes on both routes. libjpeg
(behind ``cv2.imread``) leaves every MCU after the one the data ends in
at zero coefficients, so the rest of the image is gray (128); nvJPEG
fills it its own way, and refuses one with restart markers. The card
route finds where the data ends with a Huffman walk on the host
(``jpeg_scan``), hands nvJPEG the stream completed with zero MCUs, and
sets OpenCV's gray rows itself.

:func:`image_size` reads an image's size from its header alone, in the
two ways the JAX datasets read it (PIL's stored size, or OpenCV's decoded
shape with the EXIF orientation applied).
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np
import torch

from dsl_tpu_torch.data import png
from dsl_tpu_torch.data.jpeg_scan import for_decoder, frame_size
from dsl_tpu_torch.ops import build

# leading bytes of formats a reader may hand us, for the error message
_MAGIC = ((b"\x89PNG", "PNG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
          (b"RIFF", "WebP/RIFF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
_JPEG = b"\xff\xd8\xff"
# libjpeg reads these start-of-frame markers (baseline, extended,
# progressive, lossless; Huffman or arithmetic); the hierarchical ones
# (C5-C7, CD-CF) it refuses
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB}
_SOS, _EOI, _SOI, _APP1 = 0xDA, 0xD9, 0xD8, 0xE1
_STANDALONE = {0x01} | set(range(0xD0, 0xD8))   # TEM, RST0-7: no length
_ORIENTATION_TAG = 0x0112
# the probe's first read: a header without EXIF ends within about 1 KiB; an
# APP segment (EXIF with its thumbnail) may hold 64 KiB, read as needed
PROBE_FIRST_READ = 4096


def _format_of(data: bytes) -> str:
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return f"an unknown format (first bytes {data[:4]!r})"


def read_image(path, device: str | torch.device = "cuda") -> torch.Tensor:
    """An image file -> (H, W, 3) uint8 BGR on ``device``."""
    device = torch.device(device)
    path = os.fspath(path)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"read_image: no route for device {device}")
    if os.path.isfile(path):
        with open(path, "rb") as f:
            if f.read(len(png.SIGNATURE)) == png.SIGNATURE:
                f.seek(0)
                return png.decode(f.read(), device)
    if device.type == "cpu":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        return torch.from_numpy(img)
    with open(path, "rb") as f:
        data = f.read()
    stream, fill = for_decoder(data)
    img = decode_jpeg(stream, device, path)
    if fill is not None:
        img[fill:] = 128
    return apply_orientation(img, exif_orientation(data))


def jpeg_header_end(data: bytes) -> int | None:
    """Where libjpeg's ``jpeg_read_header`` (behind ``cv2.imread``) stops
    reading real bytes of a JPEG that starts with ``data``: the end of the
    first start-of-scan segment's component selectors. None where it fails
    before that, and then ``cv2.imread`` gives no image: a segment cut
    short, an end-of-image or a second SOI before the scan, a scan before
    a frame, a hierarchical frame, a frame or scan header with a bad length
    or no components, a scan that names a component the frame lacks. Past
    the selectors libjpeg reads a cut file's missing bytes as an end-of-
    image marker and goes on (measured with OpenCV 5.0: the fixture cut
    anywhere after them decodes, the missing rest filled). Between segments
    it skips stray bytes up to the next 0xFF, as here. Table contents are
    not checked."""
    n = len(data)
    if not data.startswith(_JPEG):
        return None
    pos, frame = 2, None
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return None
        marker = data[pos]
        pos += 1
        if marker == 0 or marker in _STANDALONE:
            continue
        if marker in (_EOI, _SOI):
            return None
        if pos + 2 > n:
            return None
        length = struct.unpack_from(">H", data, pos)[0]
        if marker == _SOS:
            if frame is None or pos + 3 > n:
                return None
            ns = data[pos + 2]
            end = pos + 3 + 2 * ns
            if not 1 <= ns <= 4 or length != 2 * ns + 6 or end > n:
                return None
            if any(data[pos + 3 + 2 * i] not in frame for i in range(ns)):
                return None
            return end
        if length < 2 or pos + length > n:
            return None
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if marker not in _SOF or length < 8:
                return None
            h, w = struct.unpack_from(">HH", data, pos + 3)
            nf = data[pos + 7]
            if h == 0 or w == 0 or nf == 0 or length != 8 + 3 * nf:
                return None
            frame = {data[pos + 8 + 3 * i] for i in range(nf)}
        pos += length


def readable(path, device: str | torch.device = "cuda") -> bool:
    """Whether ``cv2.imread(path, IMREAD_COLOR)`` gives an image, judged
    without decoding: the file exists and is not empty, and a file that
    begins with the JPEG SOI marker passes :func:`jpeg_header_end` (and, on
    the card, ``nvjpegGetImageInfo`` reads its header). Only a JPEG's header
    is read: ``PROBE_FIRST_READ`` bytes, doubled until the first scan's
    header is in or the file ends. A PNG is read whole and passes
    ``png.readable`` on both routes (every chunk to IEND, the critical
    chunks' CRCs, the image data inflated): libpng refuses a PNG cut
    anywhere. A file of another format is left to the reader: on the CPU
    ``cv2.imread`` answers; on the card it counts as readable, so
    :func:`read_image` raises naming it."""
    device = torch.device(device)
    path = os.fspath(path)
    if not os.path.isfile(path):
        return False
    data = _read_header(path)
    if not data:
        return False
    if data.startswith(png.SIGNATURE):
        with open(path, "rb") as f:
            return png.readable(f.read())
    if not data.startswith(_JPEG[:2]):
        if device.type == "cpu":
            import cv2

            return cv2.imread(path, cv2.IMREAD_COLOR) is not None
        return True
    if jpeg_header_end(data) is None:
        return False
    if device.type == "cuda":
        return jpeg_info(data, device)[0] == 0
    return True


def _read_header(path: str) -> bytes:
    """The first bytes of a file: ``PROBE_FIRST_READ``, doubled while a
    JPEG's header (:func:`jpeg_header_end`) runs on, up to the whole file."""
    with open(path, "rb") as f:
        data = f.read(PROBE_FIRST_READ)
        while data.startswith(_JPEG) and jpeg_header_end(data) is None:
            more = f.read(len(data))
            if not more:
                break
            data += more
    return data


def image_size(path, oriented: bool) -> tuple[int, int]:
    """(width, height) of an image file from its header alone, as the JAX
    datasets read it without decoding:

    - ``oriented=False``: PIL's ``Image.open(path).size``
      (``dsl_tpu/data/datasets/semivoc.py``), the size as stored, the EXIF
      orientation not applied;
    - ``oriented=True``: the shape of ``cv2.imread(path)``
      (``dsl_tpu/data/datasets/voc.py``), the EXIF orientation applied (5 to
      8 swap width and height); a file ``cv2.imread`` cannot read (a JPEG
      header cut short, :func:`jpeg_header_end`) gives (0, 0).

    A missing file gives (0, 0) both ways, as both datasets skip it. JPEG
    (its frame header) and PNG (its IHDR) only; another format raises
    ValueError naming it, as does a JPEG header cut short with
    ``oriented=False`` (PIL cannot open it)."""
    path = os.fspath(path)
    if not os.path.isfile(path):
        return 0, 0
    data = _read_header(path)
    if data.startswith(b"\x89PNG\r\n\x1a\n") and data[12:16] == b"IHDR":
        return struct.unpack_from(">II", data, 16)
    if not data.startswith(_JPEG):
        raise ValueError(f"{path}: {_format_of(data)}; the size is read from "
                         f"JPEG and PNG headers only")
    if jpeg_header_end(data) is None:
        if oriented:
            return 0, 0
        raise ValueError(f"{path}: a JPEG whose header is cut short")
    h, w = frame_size(data)
    if oriented and exif_orientation(data) >= 5:
        return h, w
    return w, h


def exif_orientation(data: bytes) -> int:
    """The EXIF Orientation of a JPEG (1 to 8), read as OpenCV reads it: the
    first APP1 segment that holds ``Exif\\0\\0``, its TIFF header (``II`` or
    ``MM``, 42), IFD0's entry 0x0112, and the 16-bit value at the entry's
    value field whatever its type. A missing tag, a malformed segment or a
    value outside 1-8 gives 1 (leave the image as decoded)."""
    pos, n = 2, len(data)
    while pos + 4 <= n and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (_SOS, _EOI):
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker != _APP1 or not body.startswith(b"Exif\x00\x00"):
            continue
        tiff = body[6:]
        if tiff[:4] not in (b"II*\x00", b"MM\x00*"):
            return 1
        order = "<" if tiff[:2] == b"II" else ">"
        if len(tiff) < 8:
            return 1
        ifd = struct.unpack_from(order + "I", tiff, 4)[0]
        if ifd + 2 > len(tiff):
            return 1
        count = struct.unpack_from(order + "H", tiff, ifd)[0]
        for i in range(count):
            entry = ifd + 2 + 12 * i
            if entry + 12 > len(tiff):
                return 1
            if struct.unpack_from(order + "H", tiff, entry)[0] == _ORIENTATION_TAG:
                value = struct.unpack_from(order + "H", tiff, entry + 8)[0]
                return value if 1 <= value <= 8 else 1
        return 1
    return 1


def apply_orientation(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """OpenCV's EXIF transform of an (H, W, C) image: 2 mirrors the columns,
    3 turns it 180 degrees, 4 mirrors the rows, 5 transposes, 6 turns it 90
    degrees clockwise, 7 transposes across the other diagonal, 8 turns it
    90 degrees counter-clockwise. Views and one copy."""
    if orientation == 1:
        return img
    if orientation >= 5:
        img = img.transpose(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1), 8: (0,)}
    dims = flips[orientation]
    return (img.flip(dims) if dims else img).contiguous()


def decode_jpeg(data: bytes, device: torch.device, name: str = "<bytes>"
                ) -> torch.Tensor:
    """nvJPEG decode of a JPEG bitstream on ``device``'s current stream."""
    if not data.startswith(_JPEG):
        raise ValueError(f"{name}: {_format_of(data)} is not JPEG; the CUDA "
                         f"route decodes JPEG and PNG only")
    err, h, w, c = jpeg_info(data, device)
    if err != 0:
        raise RuntimeError(f"{name}: nvjpegGetImageInfo failed ({err})")
    if c not in (1, 3):
        raise ValueError(f"{name}: a JPEG of {c} components; the CUDA "
                         f"route takes 1 (gray) or 3 (YCbCr)")
    gray = c == 1
    buf = np.frombuffer(data, np.uint8)
    with torch.cuda.device(device):
        out = torch.empty((h, w) if gray else (h, w, 3), dtype=torch.uint8,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().dsl_jpeg_decode(buf.ctypes.data, buf.size,
                                         out.data_ptr(), w, int(gray), stream)
    if err != 0:
        raise RuntimeError(f"{name}: nvJPEG decode of {w}x{h} failed ({err})")
    decode_jpeg.decodes += 1
    return out[..., None].expand(h, w, 3).contiguous() if gray else out


decode_jpeg.decodes = 0


def jpeg_info(data: bytes, device: torch.device) -> tuple[int, int, int, int]:
    """``nvjpegGetImageInfo`` on ``device``: (return code, height, width,
    components)."""
    buf = np.frombuffer(data, np.uint8)
    width, height = ctypes.c_int(), ctypes.c_int()
    comps, css = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _library().dsl_jpeg_info(
            buf.ctypes.data, buf.size, ctypes.byref(width),
            ctypes.byref(height), ctypes.byref(comps), ctypes.byref(css))
    return err, height.value, width.value, comps.value


def _library() -> ctypes.CDLL:
    lib = build.load("nvjpeg_decode")
    if not getattr(lib, "_dsl_typed", False):
        ptr, size, intp = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
        lib.dsl_jpeg_info.argtypes = [ptr, size, intp, intp, intp, intp]
        lib.dsl_jpeg_info.restype = ctypes.c_int
        lib.dsl_jpeg_decode.argtypes = [ptr, size, ptr, ctypes.c_int,
                                        ctypes.c_int, ptr]
        lib.dsl_jpeg_decode.restype = ctypes.c_int
        lib._dsl_typed = True
    return lib
