"""Where a cut JPEG's data ends, and which rows OpenCV fills gray there.

``cv2.imread`` (OpenCV 5.0, libjpeg-turbo) decodes a sequential JPEG cut
inside its entropy-coded data: libjpeg reads the missing rest as an end
marker, decodes the MCU the data runs out in from zero bits, and leaves
every later MCU at zero coefficients, which decode to 128 in each
channel. nvJPEG decodes such a file too, and fills the rest its own way.
:func:`cut_fill_row` tells the card route (``image_io.read_image``) the
first row of OpenCV's gray band, from a walk of the Huffman codes on the
host: the standard library and numpy, no decoder.

The walk parses the DHT, DQT, DRI and frame segments and the first scan's
component selectors, unstuffs the entropy-coded bytes (``FF 00``), splits
them at restart markers (every segment but the last is whole), and steps
through the last segment MCU by MCU: each block's DC code and magnitude
bits, then AC codes to the 63rd coefficient or EOB, from a 16-bit lookup
table per Huffman table. The first MCU whose bits run past the data is
the one libjpeg decodes from zero bits; its iMCU row (a band of ``8 *``
the largest vertical sampling factor rows) is the row the data ends in.

Where the chroma is subsampled vertically (4:2:0, 4:4:0), libjpeg's
fancy upsampling mixes that band's last chroma row into the next band's
first row, which is then gray only where that chroma row is 128 across
the image (a colour file of gray content). To tell, the walk keeps the DC
predictions, and the chroma blocks of the band's last block row are
decoded in full: dequantized, put through libjpeg's integer IDCT
(``jidctint.c``, ``JDCT_ISLOW``) and upsampled as ``jdsample.c`` does.

:func:`for_decoder` gives the card route a stream that ``cv2.imread``
decodes exactly as it decodes the cut file: for a sequential file, the
cut stream completed with the zero bits libjpeg reads and zero MCUs; for a
progressive one, ``jpeg_coef``'s baseline transcode.
"""

from __future__ import annotations

import struct

import numpy as np

from dsl_tpu_torch.data.jpeg_coef import (
    _NATURAL, _ceil_div, _entropy_segments, _windows, transcode)

_SOS, _EOI, _SOI = 0xDA, 0xD9, 0xD8
_DHT, _DQT, _DRI = 0xC4, 0xDB, 0xDD
_STANDALONE = {0x01} | set(range(0xD0, 0xD8))   # TEM, RST0-7: no length
_SEQUENTIAL_HUFFMAN = (0xC0, 0xC1)


def _segments(data: bytes):
    """(marker, body) for each segment from SOI up to the first SOS, and
    the SOS with whatever of its body the data holds; standalone markers are
    skipped. Stops where a segment other than the SOS runs past the data."""
    n, pos = len(data), 2
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos + 3 > n:
            return
        marker = data[pos]
        pos += 1
        if marker == 0 or marker in _STANDALONE:
            continue
        if marker in (_EOI, _SOI):
            return
        length = struct.unpack_from(">H", data, pos)[0]
        if marker == _SOS:
            yield marker, data[pos + 2:pos + length], pos + length
            return
        if length < 2 or pos + length > n:
            return
        yield marker, data[pos + 2:pos + length], pos + length
        pos += length


def _huffman_lookup(counts: bytes, symbols: bytes, ac: bool) -> list[int]:
    """The next 16 bits of the stream -> ``bits << 16 | size << 8 | step``:
    the bits the code and its magnitude bits take, the magnitude's size, and
    for an AC table the coefficients the code covers (64 ends the block:
    EOB). A code not in the table takes 17 bits and reads as symbol 0, as
    libjpeg's ``jpeg_huff_decode`` reads it."""
    table = [(17 << 16) | (64 if ac else 0)] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            sym = symbols[k]
            k += 1
            run, size = sym >> 4, sym & 15
            if not ac:
                entry = ((length + sym) << 16) | (sym << 8)
            elif size == 0:
                entry = (length << 16) | (16 if run == 15 else 64)
            else:
                entry = ((length + size) << 16) | (size << 8) | (run + 1)
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            if hi <= 65536:
                table[lo:hi] = [entry] * (hi - lo)
            code += 1
        code <<= 1
    return table


def _huffman_codes(counts: bytes, symbols: bytes) -> dict[int, str]:
    """Each symbol's canonical Huffman code, as a string of bits."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = format(code, f"0{length}b")
            k += 1
            code += 1
        code <<= 1
    return out


def _magnitude(w: list[int], p: int, size: int) -> int:
    """The value of ``size`` magnitude bits at bit ``p`` (JPEG's EXTEND)."""
    if size == 0:
        return 0
    v = (w[p >> 3] >> (32 - (p & 7) - size)) & ((1 << size) - 1)
    return v if v >> (size - 1) else v - (1 << size) + 1


class _Scan:
    """The frame, the tables and the one scan of a sequential JPEG."""

    def __init__(self, data: bytes):
        self.ok = False
        huff, codes, quant, frame, scan = {}, {}, {}, None, None
        self.restart = 0
        for marker, body, end in _segments(data):
            if marker == _DHT:
                i = 0
                while i + 17 <= len(body):
                    tc, th = body[i] >> 4, body[i] & 15
                    counts = body[i + 1:i + 17]
                    stop = i + 17 + sum(counts)
                    huff[(tc, th)] = _huffman_lookup(counts, body[i + 17:stop],
                                                     tc == 1)
                    codes[(tc, th)] = _huffman_codes(counts, body[i + 17:stop])
                    i = stop
            elif marker == _DQT:
                i = 0
                while i < len(body):
                    wide, tq = body[i] >> 4, body[i] & 15
                    n = 128 if wide else 64
                    quant[tq] = np.frombuffer(body[i + 1:i + 1 + n],
                                              ">u2" if wide else np.uint8)
                    i += 1 + n
            elif marker == _DRI and len(body) >= 2:
                self.restart = struct.unpack_from(">H", body)[0]
            elif 0xC0 <= marker <= 0xCF and marker not in (_DHT, 0xC8, 0xCC):
                if marker not in _SEQUENTIAL_HUFFMAN or len(body) < 6:
                    return
                h, w, nf = *struct.unpack_from(">HH", body, 1), body[5]
                frame = (h, w, [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                 body[7 + 3 * i] & 15, body[8 + 3 * i])
                                for i in range(nf)])
            elif marker == _SOS:
                ns = body[0] if body else 0
                if len(body) < 1 + 2 * ns:
                    return
                scan = [(body[1 + 2 * i], body[2 + 2 * i]) for i in range(ns)]
                self.entropy_start = min(end, len(data))
                # a cut inside the scan header's last bytes (spectral
                # selection, approximation): a sequential scan's values
                self.header = data[:self.entropy_start] + b"\x00\x3f\x00"[
                    3 - max(0, end - len(data)):]
        if frame is None or scan is None:
            return
        self.height, self.width, comps = frame
        by_id = {c[0]: c for c in comps}
        if (self.height == 0 or len(scan) != len(comps)
                or any(c not in by_id for c, _ in scan)):
            return
        self.hmax = max(c[1] for c in comps)
        self.vmax = max(c[2] for c in comps)
        # per block of an MCU: (DC table, AC table, component, block row,
        # block column within the component's share of the MCU)
        self.blocks, self.comps, self.codes = [], [], []
        for ci, (cid, t) in enumerate(scan):
            if (0, t >> 4) not in huff or (1, t & 15) not in huff:
                return
            _, hs, vs, tq = by_id[cid]
            if len(scan) == 1:
                hs = vs = 1
            self.comps.append((hs, vs, quant.get(tq)))
            self.codes.append((codes[(0, t >> 4)], codes[(1, t & 15)]))
            self.blocks += [(huff[(0, t >> 4)], huff[(1, t & 15)], ci, r, c)
                            for r in range(vs) for c in range(hs)]
        if len(scan) > 1:
            self.mcus_x = _ceil_div(self.width, 8 * self.hmax)
            self.mcus_y = _ceil_div(self.height, 8 * self.vmax)
            self.rows_per_imcu = 1
        else:               # one component: an MCU is one block
            _, hs, vs, _ = comps[0]
            self.mcus_x = _ceil_div(_ceil_div(self.width * hs, self.hmax), 8)
            self.mcus_y = _ceil_div(_ceil_div(self.height * vs, self.vmax), 8)
            self.rows_per_imcu = vs
        self.ok = True

    def walk(self, seg: bytes, count: int, p: int, preds: list[int]):
        """Step through up to ``count`` MCUs of one segment from bit ``p``
        with the DC predictions ``preds``: the first MCU whose bits run past
        the segment's end (libjpeg decodes it from zero bits), or None where
        all of them fit; the bit position and predictions at the start of
        each MCU stepped through; and those after the last MCU stepped
        through (the short one where there is one)."""
        w = _windows(seg)
        total = 8 * len(seg)
        starts = []
        for m in range(count):
            starts.append((p, list(preds)))
            for dc, ac, ci, _, _ in self.blocks:
                e = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 16
                size = (e >> 8) & 0xFF
                if size:
                    v = (w[(p - size) >> 3] >> (32 - ((p - size) & 7) - size)
                         ) & ((1 << size) - 1)
                    preds[ci] += v if v >> (size - 1) else v - (1 << size) + 1
                k = 1
                while k < 64:
                    e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 16
                    k += e & 0xFF
            if p > total:
                return m, starts, (p, preds)
        return None, starts, (p, preds)

    def decode(self, seg: bytes, count: int, p: int, preds: list[int],
               keep) -> dict:
        """Decode ``count`` MCUs of one segment from bit ``p`` (zero bits
        past its end), as libjpeg's ``decode_mcu_slow`` does; returns, for
        each MCU ``m`` and block ``b`` where ``keep(m, b)``, the block's 64
        coefficients in zigzag order (JCOEF, 16-bit)."""
        w = _windows(seg)
        kept = {}
        for m in range(count):
            for bi, (dc, ac, ci, _, _) in enumerate(self.blocks):
                e = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                size = (e >> 8) & 0xFF
                p += e >> 16
                preds[ci] += _magnitude(w, p - size, size)
                coef = [preds[ci]] + [0] * 63
                k = 1
                while k < 64:
                    e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    size, step = (e >> 8) & 0xFF, e & 0xFF
                    p += e >> 16
                    if size:
                        k += step - 1
                        if k < 64:
                            coef[k] = _magnitude(w, p - size, size)
                        k += 1
                    else:
                        k += step
                if keep(m, bi):
                    kept[(m, bi)] = [((c + 32768) & 0xFFFF) - 32768
                                     for c in coef]
        return kept


def _idct_1d(x):
    """jidctint.c's 1-D pass on the 8 inputs ``x`` (arrays), undescaled."""
    z1 = (x[2] + x[6]) * 4433
    t2 = z1 - x[6] * 15137
    t3 = z1 + x[2] * 6270
    t0 = (x[0] + x[4]) << 13
    t1 = (x[0] - x[4]) << 13
    e10, e13, e11, e12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633
    o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [e10 + o3, e11 + o2, e12 + o1, e13 + o0,
            e13 - o0, e12 - o1, e11 - o2, e10 - o3]


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` of dequantized (N, 8, 8) coefficients
    in natural order: (N, 8, 8) samples, range-limited as its
    ``IDCT_range_limit`` table limits them (wrapping far outside)."""
    c = coef.astype(np.int64)
    ws = np.stack([_descale(v, 11) for v in _idct_1d(
        [c[:, i, :] for i in range(8)])], axis=1)            # columns
    out = np.stack([_descale(v, 18) for v in _idct_1d(
        [ws[:, :, i] for i in range(8)])], axis=2)           # rows
    v = out & 1023
    return np.where(v < 128, v + 128, np.where(
        v < 512, 255, np.where(v < 896, 0, v - 896))).astype(np.uint8)


def _bleed(last: np.ndarray, h_ratio: int, width: int) -> np.ndarray:
    """The first output row of a band whose own chroma rows are all 128,
    upsampled by jdsample.c's fancy ``h2v2`` (``h_ratio`` 2) or ``h1v2``
    (1) from ``last``, the previous band's last chroma row."""
    colsum = 3 * 128 + last.astype(np.int64)
    if h_ratio == 1:
        return ((colsum + 1) >> 2)[:width]
    before = np.concatenate([colsum[:1], colsum[:-1]])
    after = np.concatenate([colsum[1:], colsum[-1:]])
    out = np.empty(2 * len(colsum), np.int64)
    out[0::2] = (colsum * 3 + before + 8) >> 4
    out[1::2] = (colsum * 3 + after + 7) >> 4
    return out[:width]


def _cut(data: bytes):
    """(iMCU row the data ends in, the first row OpenCV fills gray or None
    where that is past the last row, a function that makes the completed
    stream) for a baseline or extended-sequential JPEG with one scan whose
    data ends before its last MCU; None otherwise (see
    :func:`cut_fill_row`)."""
    if data.endswith(b"\xff\xd9") or not data.startswith(b"\xff\xd8\xff"):
        return None
    scan = _Scan(data)
    if not scan.ok:
        return None
    total = scan.mcus_x * scan.mcus_y
    interval = scan.restart or total
    segs = _entropy_segments(data, scan.entropy_start)
    first = (len(segs) - 1) * interval      # the earlier segments are whole
    if first >= total:
        return None
    short, starts, after = scan.walk(segs[-1], min(interval, total - first),
                                     0, [0] * len(scan.comps))
    if short is None:
        # the data ends on a restart boundary: libjpeg decodes the next
        # segment's first MCU from zero bits, its predictions reset
        short, _, after = scan.walk(b"", 1, 0, [0] * len(scan.comps))
        short = first + interval
    else:
        short += first
    if short >= total:
        return None
    k = (short // scan.mcus_x) // scan.rows_per_imcu
    row = (k + 1) * 8 * scan.vmax
    bleeding = [ci for ci, (hs, vs, _) in enumerate(scan.comps)
                if len(scan.comps) > 1 and scan.vmax == 2 * vs
                and (scan.hmax == hs or (scan.hmax == 2 * hs and _ceil_div(
                    scan.width * hs, scan.hmax) > 2))]
    if bleeding and not _next_band_gray(scan, segs, interval, first, starts,
                                        k, short, bleeding):
        row += 1
    return (k, row if row < scan.height else None,
            lambda: _completed(scan, segs, interval, short, after))


def _zero_mcus(scan, count: int, preds: list[int]) -> str | None:
    """The bits of ``count`` MCUs of zero coefficients: each block a DC
    difference and EOB, the first block of each component taking its DC
    prediction back to 0. None where a table lacks a code this needs."""
    bits = []
    for m in range(min(count, 2)):
        mcu = []
        for _, _, ci, _, _ in scan.blocks:
            dc, ac = scan.codes[ci]
            diff, preds[ci] = -preds[ci], 0
            size = abs(diff).bit_length()
            if size not in dc or 0 not in ac:
                return None
            mag = diff if diff >= 0 else diff + (1 << size) - 1
            mcu.append(dc[size] + (format(mag, f"0{size}b") if size else "")
                       + ac[0])
        bits.append("".join(mcu))
    return bits[0] + bits[-1] * (count - 1) if count else ""


def _packed(bits: str) -> bytes:
    """Bits padded with ones to a byte, packed, ``FF`` bytes stuffed."""
    bits += "1" * (-len(bits) % 8)
    raw = int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""
    return raw.replace(b"\xff", b"\xff\x00")


def _completed(scan, segs, interval, short, after) -> bytes | None:
    """A whole stream for a decoder that refuses a cut one (nvJPEG refuses
    a cut file with restart markers) and that ``cv2.imread`` decodes as it
    decodes the cut file: the entropy-coded bits up to the data's end, the
    zero bits that finish the MCU the data runs out in (libjpeg decodes it
    from them; ``after``: the bit position and DC predictions at its end),
    every later MCU as zero coefficients (:func:`_zero_mcus`), restart
    markers where the interval puts them, and EOI. None where a table
    lacks a code."""
    total = scan.mcus_x * scan.mcus_y
    out = bytearray(scan.header)
    for i, seg in enumerate(segs[:-1]):
        out += seg.replace(b"\xff", b"\xff\x00") + bytes([0xFF, 0xD0 + i % 8])
    held = short // interval              # the segment the short MCU is in
    data = segs[-1] if held == len(segs) - 1 else b""
    if held > len(segs) - 1:
        out += segs[-1].replace(b"\xff", b"\xff\x00") + bytes(
            [0xFF, 0xD0 + (held - 1) % 8])
    end, preds = after
    bits = format(int.from_bytes(data, "big"), f"0{8 * len(data)}b") if data else ""
    zeros = _zero_mcus(scan, min((held + 1) * interval, total) - short - 1,
                       list(preds))
    if zeros is None:
        return None
    out += _packed(bits + "0" * (end - len(bits)) + zeros)
    for seg in range(held + 1, _ceil_div(total, interval)):
        zeros = _zero_mcus(scan, min(interval, total - seg * interval),
                           [0] * len(scan.comps))
        if zeros is None:
            return None
        out += bytes([0xFF, 0xD0 + (seg - 1) % 8]) + _packed(zeros)
    return bytes(out) + b"\xff\xd9"


def _next_band_gray(scan, segs, interval, first, starts, k, short,
                    bleeding) -> bool:
    """Whether the first row after iMCU row ``k`` is gray in OpenCV's
    decode: each vertically subsampled chroma component's bleed from row
    ``k``'s last chroma row is 128 across the image. The MCUs of row ``k``
    up to ``short`` are decoded in full (from the checkpoint the walk left,
    or from the start of their restart segment), the rest are zero."""
    row_start = k * scan.mcus_x
    bottom = {bi for bi, (_, _, ci, r, _) in enumerate(scan.blocks)
              if ci in bleeding and r == scan.comps[ci][1] - 1}
    kept = {}
    for seg in range(row_start // interval, short // interval + 1):
        if seg == len(segs) - 1 and row_start >= first:
            begin = row_start               # from the walk's checkpoint
            p, preds = starts[begin - first]
            preds = list(preds)
        else:
            begin = seg * interval
            p, preds = 0, [0] * len(scan.comps)
        count = min((seg + 1) * interval, short + 1) - begin
        got = scan.decode(segs[seg] if seg < len(segs) else b"", count, p,
                          preds, lambda m, b, begin=begin:
                          begin + m >= row_start and b in bottom)
        kept.update({(begin + m, b): c for (m, b), c in got.items()})
    for ci in bleeding:
        hs, vs, quant = scan.comps[ci]
        if quant is None:
            return False
        last = np.full(scan.mcus_x * hs * 8, 128, np.int64)
        for (m, bi), coef in kept.items():
            if scan.blocks[bi][2] != ci:
                continue
            deq = np.zeros(64, np.int64)
            deq[_NATURAL] = np.asarray(coef, np.int64) * quant.astype(np.int64)
            col = ((m - row_start) * hs + scan.blocks[bi][4]) * 8
            last[col:col + 8] = _idct_islow(deq.reshape(1, 8, 8))[0, 7]
        width = _ceil_div(scan.width * hs, scan.hmax)
        if (_bleed(last[:width], scan.hmax // hs, scan.width) != 128).any():
            return False
    return True


def truncated_imcu_row(data: bytes) -> int | None:
    """The iMCU row (a band of ``8 *`` the largest vertical sampling factor
    rows) in which a sequential JPEG's entropy-coded data runs out, or None
    where every MCU is present or the file is not covered (see
    :func:`cut_fill_row`). A file that ends in EOI costs one ``endswith``."""
    cut = _cut(data)
    return None if cut is None else cut[0]


def cut_fill_row(data: bytes) -> int | None:
    """The first row of a cut JPEG from which ``cv2.imread`` (OpenCV 5.0,
    libjpeg-turbo) gives 128 in every channel to the bottom, or None where
    it fills no whole row.

    With the data ending in iMCU row ``k`` (:func:`truncated_imcu_row`),
    the rows from ``(k + 1) * band`` down are gray, ``band`` being the
    iMCU row's height; where the chroma is subsampled vertically (4:2:0,
    4:4:0) and the band's last chroma row is not 128 everywhere, fancy
    upsampling bleeds it into the next row, and the gray starts one row
    lower. Held against ``cv2.imread`` by
    ``tests/test_torch_port_image.py::test_truncated_imcu_row_is_cv2s_fill``.

    Not covered, and None: progressive files (``jpeg_coef`` transcodes
    those, with libjpeg's smoothing), lossless or arithmetic-coded ones, a
    sequential file of more than one scan, and a band whose own rows
    OpenCV decodes to 128 across the image above ``(k + 1) * band``."""
    cut = _cut(data)
    return None if cut is None else cut[1]


def for_decoder(data: bytes) -> tuple[bytes, int | None]:
    """What the card route hands nvJPEG, and the first row it then sets to
    128; ``cv2.imread`` of the stream equals ``cv2.imread`` of ``data``:

    - a progressive file cut inside its data: the baseline transcode of
      the coefficients libjpeg's IDCT reads for it, interblock smoothing
      included (``jpeg_coef.transcode``); no row is set, the coefficients
      carry OpenCV's fill;
    - a sequential file cut inside its scan (:func:`_cut`): the completed
      stream (:func:`_completed`: the data's bits, the zero bits that end
      the MCU the data runs out in, zero MCUs after it; nvJPEG refuses a
      cut file with restart markers) and :func:`cut_fill_row`, from which
      nvJPEG's own upsampling of the zero MCUs is overwritten with OpenCV's
      gray;
    - anything else (a whole file, a cut this does not cover: inside a
      segment's header, arithmetic-coded, lossless, 12-bit, a sequential
      file of several scans): ``data`` as it is and None."""
    progressive = transcode(data)
    if progressive is not None:
        return progressive, None
    cut = _cut(data)
    if cut is None:
        return data, None
    stream = cut[2]()
    return (data if stream is None else stream), cut[1]


def frame_size(data: bytes) -> tuple[int, int] | None:
    """(height, width) from a JPEG's first frame header, or None where the
    data holds none."""
    for marker, body, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (_DHT, 0xC8, 0xCC):
            return struct.unpack_from(">HH", body, 1) if len(body) >= 5 else None
    return None
