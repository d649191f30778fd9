"""PNG files read as ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads them.

OpenCV 5.0 reads PNG through libpng 1.6; the JAX package reads every image
that way (``LoadImageFromFile``, the refresher, ``single_device_test``,
``inference_detector``). This module is the port's reader, in three steps:

1. :func:`parse` walks the file (the signature; every chunk's length and
   CRC-32; IHDR, PLTE, the first run of IDAT chunks inflated through
   ``zlib.decompressobj``, IEND) and raises :class:`PngError` wherever
   libpng stops with an error, so ``cv2.imread`` gives no image: a file cut
   anywhere (also one that lacks only its IEND chunk), a critical chunk
   with a bad CRC, a zlib stream that is damaged, that does not end (its
   Adler-32 missing or wrong) or that ends before the image data does, a
   row filter type past 4, a bad IHDR, an unknown critical chunk. An
   ancillary chunk with a bad CRC is dropped, as libpng drops it with a
   warning; IEND's CRC is not read (OpenCV 5.0 stops at the chunk's name);
   data past the stream's end, or more rows than the image holds, are
   ignored (measured against ``cv2.imdecode``).
2. The rows are unfiltered (None, Sub, Up, Average, Paeth) on the host,
   pass by pass for an Adam7 file: :func:`unfilter_reference` is the plain
   numpy version; :func:`unfilter_host` calls the C function in
   ``csrc/png_unfilter.cpp`` (built by ``ops/build.py``), which the card
   route uses, since Average and Paeth depend on the pixel to their left
   and a per-pixel Python loop over a full frame takes seconds.
3. :func:`to_bgr` applies OpenCV's colour rules with torch ops on the
   image's device: 16-bit samples keep their high byte (``png_set_strip_16``
   truncates), 1-, 2- and 4-bit gray is scaled to 8 bits, gray is copied
   into three channels, the palette is expanded (an index past the
   palette's entries gives black), alpha and tRNS are dropped, not
   composited, and the channels come out BGR. An Adam7 file's passes are
   placed into the image there too.

:func:`decode` is the whole read: on the card the unfiltered rows and the
palette reach the device in one pinned upload; on the CPU the plain
version unfilters, so both routes give the same tensor and the CPU tests
hold it to ``cv2.imread`` bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import zlib

import numpy as np
import torch

from dsl_tpu_torch.ops import build
from dsl_tpu_torch.utils.device import to_device

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7 passes: first column, first row, column step, row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
              6: (8, 16)}
# libpng's default user limits on width and height (png_set_user_limits)
USER_SIZE_MAX = 1_000_000
_UINT31_MAX = 0x7FFFFFFF


class PngError(ValueError):
    """A PNG that libpng (behind ``cv2.imread``) stops reading."""


@dataclasses.dataclass(frozen=True)
class PngImage:
    """A parsed PNG: the header, the palette and the filtered rows."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    # (first column, first row, column step, row step, width, height) of
    # each pass holding pixels: one for a plain file, up to seven for Adam7
    passes: tuple
    # (256, 3) uint8 RGB, zero past the file's entries; None but for type 3
    palette: np.ndarray | None
    # the inflated stream, pass by pass: each row a filter byte and its bytes
    filtered: bytes

    @property
    def channels(self) -> int:
        return CHANNELS[self.color_type]

    @property
    def bpp(self) -> int:
        """Bytes per complete pixel, at least 1 (the filters' left step)."""
        return max(1, self.channels * self.bit_depth // 8)

    def rowbytes(self, width: int) -> int:
        return (width * self.channels * self.bit_depth + 7) // 8


def _passes(width: int, height: int, interlace: int) -> tuple:
    if interlace == 0:
        return ((0, 0, 1, 1, width, height),)
    out = []
    for x0, y0, dx, dy in ADAM7:
        w = (width - x0 + dx - 1) // dx if width > x0 else 0
        h = (height - y0 + dy - 1) // dy if height > y0 else 0
        if w and h:
            out.append((x0, y0, dx, dy, w, h))
    return tuple(out)


def _ihdr(body: bytes) -> tuple[int, int, int, int, int]:
    if len(body) != 13:
        raise PngError("IHDR of a bad length")
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", body)
    if not (0 < width <= min(_UINT31_MAX, USER_SIZE_MAX)
            and 0 < height <= min(_UINT31_MAX, USER_SIZE_MAX)):
        raise PngError(f"image size {width}x{height} out of range")
    if depth not in BIT_DEPTHS.get(ctype, ()):
        raise PngError(f"bit depth {depth} with colour type {ctype}")
    if comp != 0 or filt != 0 or interlace > 1:
        raise PngError("unknown compression, filter or interlace method")
    return width, height, depth, ctype, interlace


def _chunk_name_ok(name: bytes) -> bool:
    return all(65 <= c <= 90 or 97 <= c <= 122 for c in name)


def parse(data: bytes) -> PngImage:
    """The header, palette and filtered rows of a PNG, or :class:`PngError`
    where libpng would stop with an error (module docstring)."""
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG signature")
    n = len(data)
    pos = 8
    header = palette = None
    idat: list[bytes] = []
    idat_closed = False           # a chunk other than IDAT followed the run
    while True:
        if pos + 8 > n:
            raise PngError("file cut inside a chunk header")
        length, name = struct.unpack_from(">I4s", data, pos)
        if length > _UINT31_MAX or not _chunk_name_ok(name):
            raise PngError(f"bad chunk header at byte {pos}")
        end = pos + 12 + length
        if end > n:
            raise PngError(f"file cut inside chunk {name!r}")
        body = data[pos + 8:pos + 8 + length]
        critical = not name[0] & 0x20
        crc = struct.unpack_from(">I", data, end - 4)[0]
        pos = end
        if name != b"IEND" and zlib.crc32(body, zlib.crc32(name)) != crc:
            if critical:
                raise PngError(f"CRC error in chunk {name!r}")
            continue                      # libpng drops it with a warning
        if header is None and name != b"IHDR":
            raise PngError("missing IHDR")
        if name == b"IDAT":
            if header[3] == 3 and palette is None:
                raise PngError("missing PLTE before IDAT")
            if not idat_closed:
                idat.append(body)
            continue
        if idat:
            idat_closed = True
        if name == b"IHDR":
            if header is not None:
                raise PngError("duplicate IHDR")
            header = _ihdr(body)
        elif name == b"PLTE":
            palette = _plte(body, header, palette, bool(idat))
        elif name == b"IEND":
            break
        elif critical:
            raise PngError(f"unknown critical chunk {name!r}")
    if not idat:
        raise PngError("no image data")
    width, height, depth, ctype, interlace = header
    image = PngImage(width, height, depth, ctype, _passes(width, height, interlace),
                     palette if ctype == 3 else None, b"")
    need = sum(h * (1 + image.rowbytes(w)) for *_, w, h in image.passes)
    inflate = zlib.decompressobj()
    try:
        rows = inflate.decompress(b"".join(idat))
    except zlib.error as err:
        raise PngError(f"damaged image data: {err}") from None
    if not inflate.eof:
        raise PngError("the image data's zlib stream does not end")
    if len(rows) < need:
        raise PngError("not enough image data")
    rows = rows[:need]
    pos = 0
    for *_, w, h in image.passes:
        step = 1 + image.rowbytes(w)
        if max(rows[pos:pos + h * step:step]) > 4:
            raise PngError("bad adaptive filter value")
        pos += h * step
    return dataclasses.replace(image, filtered=rows)


def _plte(body: bytes, header, palette, after_idat: bool):
    """libpng's ``png_handle_PLTE``: (256, 3) RGB entries, zero-filled."""
    ctype = header[3]
    if palette is not None:
        raise PngError("duplicate PLTE")
    if after_idat:
        raise PngError("PLTE after IDAT")
    if len(body) > 3 * 256 or len(body) % 3:
        if ctype == 3:
            raise PngError("invalid PLTE")
        return None
    if not ctype & 2:                 # grayscale: ignored with a warning
        return None
    num = min(len(body) // 3, 1 << header[2] if ctype == 3 else 256)
    if ctype == 3 and num == 0:
        raise PngError("invalid PLTE")
    out = np.zeros((256, 3), np.uint8)
    out[:num] = np.frombuffer(body[:3 * num], np.uint8).reshape(num, 3)
    return out


def readable(data: bytes) -> bool:
    """Whether ``cv2.imread`` reads a PNG file of these bytes."""
    try:
        parse(data)
    except PngError:
        return False
    return True


# -- unfiltering -----------------------------------------------------------


def _pass_rows(image: PngImage):
    """(rows, rowbytes, start offset) of each pass in ``image.filtered``."""
    pos = 0
    for *_, w, h in image.passes:
        rb = image.rowbytes(w)
        yield h, rb, pos
        pos += h * (1 + rb)


def unfilter_reference(image: PngImage) -> np.ndarray:
    """The unfiltered rows of every pass, concatenated (uint8, the filter
    bytes dropped): the plain numpy version. None, Sub and Up run whole
    rows; Average and Paeth step pixel by pixel (each depends on the
    result to its left), vectorised over the pixel's bytes."""
    bpp = image.bpp
    out = []
    for h, rb, pos in _pass_rows(image):
        rows = np.frombuffer(image.filtered, np.uint8, h * (1 + rb),
                             pos).reshape(h, 1 + rb)
        prev = np.zeros(rb, np.int32)
        res = np.empty((h, rb), np.uint8)
        for y in range(h):
            ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
            if ftype == 0:
                cur = line
            elif ftype == 1:
                pad = (-rb) % bpp
                lanes = np.concatenate([line, np.zeros(pad, np.int32)])
                cur = (np.cumsum(lanes.reshape(-1, bpp), 0) & 255
                       ).reshape(-1)[:rb]
            elif ftype == 2:
                cur = (line + prev) & 255
            else:
                cur = np.empty(rb, np.int32)
                for x in range(0, rb, bpp):
                    sl = slice(x, x + bpp)
                    up = prev[sl]
                    left = cur[x - bpp:x] if x else np.zeros_like(up)
                    if ftype == 3:
                        pred = (left + up) >> 1
                    else:
                        upleft = prev[x - bpp:x] if x else np.zeros_like(up)
                        pa = np.abs(up - upleft)
                        pb = np.abs(left - upleft)
                        pc = np.abs(left + up - 2 * upleft)
                        pred = np.where((pa <= pb) & (pa <= pc), left,
                                        np.where(pb <= pc, up, upleft))
                    cur[sl] = (line[sl] + pred) & 255
            res[y] = cur
            prev = cur
        out.append(res.reshape(-1))
    return np.concatenate(out)


def unfilter_host(image: PngImage, out: np.ndarray | None = None) -> np.ndarray:
    """:func:`unfilter_reference`'s result from the C function
    ``dsl_png_unfilter`` (``csrc/png_unfilter.cpp``), written into ``out``
    where given (a buffer of the rows' size, e.g. pinned memory)."""
    lib = _library()
    total = sum(h * rb for h, rb, _ in _pass_rows(image))
    if out is None:
        out = np.empty(total, np.uint8)
    if out.size < total or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("unfilter_host: out must be contiguous uint8 of "
                         f"{total} bytes")
    src = np.frombuffer(image.filtered, np.uint8)
    done = 0
    for h, rb, pos in _pass_rows(image):
        err = lib.dsl_png_unfilter(src.ctypes.data + pos,
                                   out.ctypes.data + done, h, rb, image.bpp)
        if err != 0:
            raise PngError("bad adaptive filter value")
        done += h * rb
    return out[:total]


def _library() -> ctypes.CDLL:
    lib = build.load("png_unfilter")
    if not getattr(lib, "_dsl_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dsl_png_unfilter.argtypes = [ptr, ptr, i64, i64, ctypes.c_int]
        lib.dsl_png_unfilter.restype = ctypes.c_int
        lib._dsl_typed = True
    return lib


# -- colour, on the device -------------------------------------------------


def _samples(rows: torch.Tensor, image: PngImage, w: int) -> torch.Tensor:
    """One pass's unfiltered rows (h, rowbytes) -> (h, w, channels) uint8
    samples: a 16-bit sample's high byte, a 1/2/4-bit sample unscaled."""
    h = rows.shape[0]
    c, depth = image.channels, image.bit_depth
    if depth == 8:
        return rows.reshape(h, w, c)
    if depth == 16:
        return rows.reshape(h, w, c, 2)[..., 0]
    shifts = torch.arange(8 - depth, -1, -depth, device=rows.device,
                          dtype=torch.uint8)
    bits = (rows[..., None] >> shifts) & ((1 << depth) - 1)
    return bits.reshape(h, -1)[:, :w].reshape(h, w, 1)


def to_bgr(raw: torch.Tensor, image: PngImage,
           palette: torch.Tensor | None = None) -> torch.Tensor:
    """Unfiltered rows (1-D uint8, every pass, on the image's device) ->
    (H, W, 3) uint8 BGR with OpenCV's colour rules (module docstring).
    ``palette`` is the (256, 3) BGR table on the same device (type 3)."""
    passes = []
    pos = 0
    for (x0, y0, dx, dy, w, h), (_, rb, _) in zip(image.passes,
                                                  _pass_rows(image)):
        rows = raw[pos:pos + h * rb].reshape(h, rb)
        passes.append(((x0, y0, dx, dy), _samples(rows, image, w)))
        pos += h * rb
    if len(passes) == 1:
        samples = passes[0][1]
    else:
        samples = raw.new_empty((image.height, image.width, image.channels))
        for (x0, y0, dx, dy), s in passes:
            samples[y0::dy, x0::dx] = s
    ctype = image.color_type
    if ctype == 3:
        return palette[samples[..., 0].to(torch.int64)]
    if ctype in (2, 6):
        return samples[..., :3].flip(-1)
    gray = samples[..., 0]
    if image.bit_depth < 8:
        gray = gray * (255 // ((1 << image.bit_depth) - 1))
    return gray[..., None].expand(image.height, image.width, 3).contiguous()


def decode(data: bytes, device: str | torch.device = "cuda") -> torch.Tensor:
    """A PNG's bytes -> (H, W, 3) uint8 BGR on ``device``, as ``cv2.imread``
    reads it. On the card the C function unfilters into pinned memory that
    also holds the palette, and one upload carries both; on the CPU the
    plain version unfilters. Raises :class:`PngError` where ``cv2.imread``
    gives no image."""
    device = torch.device(device)
    image = parse(data)
    total = sum(h * rb for h, rb, _ in _pass_rows(image))
    pal = image.palette
    if device.type == "cpu":
        raw = torch.from_numpy(unfilter_reference(image))
        palette = None if pal is None else torch.from_numpy(pal[:, ::-1].copy())
        return to_bgr(raw, image, palette)
    if device.type != "cuda":
        raise ValueError(f"png.decode: no route for device {device}")
    staged = torch.empty(total + (0 if pal is None else pal.size),
                         dtype=torch.uint8, pin_memory=True)
    buf = staged.numpy()
    unfilter_host(image, buf[:total])
    if pal is not None:
        buf[total:] = pal[:, ::-1].reshape(-1)
    on_card = to_device(staged, device)
    palette = None if pal is None else on_card[total:].reshape(256, 3)
    return to_bgr(on_card[:total], image, palette)
