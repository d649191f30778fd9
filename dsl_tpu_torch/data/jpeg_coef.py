"""A cut progressive JPEG's coefficients as libjpeg ends with them, and
their baseline transcode.

``cv2.imread`` (OpenCV 5.0, libjpeg-turbo 3.1) reads a progressive JPEG
whose data ends early: it keeps every coefficient of the scans before the
cut, decodes the scan the data ends in up to the MCU the data runs out in
(that MCU from zero bits), and leaves the rest of that scan as the earlier
scans left it. Before the inverse DCT it estimates the low AC coefficients
the file has not delivered from the neighbouring blocks' DC values
(interblock smoothing, ``jdcoefct.c::decompress_smooth_data``), so even a
file cut in its DC scan decodes to a smooth image. nvJPEG does no such
smoothing, so a stream holding only the received coefficients decodes on
the card to another image.

:func:`transcode` rebuilds on the host, in numpy and the standard library,
the coefficient arrays libjpeg feeds its IDCT (smoothing included) and
writes them as a baseline JPEG: SOF0 with the file's dimensions, component
ids, sampling factors and quantization tables, the Huffman tables of the
JPEG standard's Annex K, no restart markers. ``cv2.imread`` of it equals
``cv2.imread`` of the cut file bit for bit
(``tests/test_torch_port_image.py``), and nvJPEG decodes it. The APP and
COM segments before the frame are kept as they are (a JFIF or Adobe
segment decides the colour transform; the EXIF orientation is read from
the original bytes all the same).

The decode follows ``jdphuff.c``: DC first and refinement scans, AC first
scans with EOB runs, AC refinement scans with correction bits, restart
intervals (a restart resets the DC predictions and the EOB run), and the
progression status ``coef_bits`` (with the status before the component's
latest scan) marked over a scan's whole band at its start. An MCU whose
bits run past the data is decoded from zero bits and every later MCU of
that scan is left untouched; where the data ends on a restart boundary,
the next segment's first MCU is decoded from zero bits.

Pure Python over the Huffman codes: a cut 640x427 colour file takes under
0.1 s (``chip_smoke.py`` phase 8 prints the time).
Not covered (:func:`transcode` gives None): a file that is whole, not
progressive Huffman (arithmetic-coded, lossless, sequential), 12-bit, or
cut inside a segment's header.
"""

from __future__ import annotations

import struct

import numpy as np

# zero bytes after a segment: more than one MCU's bits (10 blocks of 64
# codes of at most 27 bits), so an MCU that runs past the data reads zeros,
# as libjpeg's bit reader does
_ZERO_TAIL = b"\0" * 2304
# zigzag index -> natural (row-major) index of a coefficient
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_SOS, _EOI, _SOI, _DHT, _DQT, _DRI, _COM = 0xDA, 0xD9, 0xD8, 0xC4, 0xDB, 0xDD, 0xFE
_PROGRESSIVE_HUFFMAN = 0xC2
# zigzag index -> natural index, with jdphuff's 16 guard entries past the
# end (a run past the band writes coefficient 63)
_NATURAL_EXT = _NATURAL.tolist() + [63] * 16
# jdcoefct.c's SAVED_COEFS: DC and the first 9 AC coefficients (zigzag)
_SAVED = 10

# Annex K (ITU T.81, K.3): (counts per code length, symbols) of the
# luminance and chrominance DC and AC tables
_K_DC = ((bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
         (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))))
_K_AC = ((bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352"
        "f0156272d10a162434e125f11718191a262728292a35363738393a4344454647"
        "48494a535455565758595a636465666768696a737475767778797a8283848586"
        "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
        "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7"
        "f8f9fa")))

# jdcoefct.c's smoothing weights over the 5x5 DC window DC01..DC25 (row
# by row, the block's own DC at DC13): a name ending in "s" weighs once AC
# data has arrived, the others while only DC scans are in (DC
# interpolation, which also re-estimates DC itself)
_W = {
    "AC01": {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3,
             12: 38, 14: -38, 15: 3, 16: -3, 17: 13, 19: -13, 20: 3, 21: -1,
             22: -1, 24: 1, 25: 1},
    "AC01s": {11: -7, 12: 50, 14: -50, 15: 7},
    "AC20": {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7,
             19: 2, 23: 1},
    "AC20s": {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
    "AC11": {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1},
    "AC11s": {10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1,
              4: 1, 6: -1, 7: 10, 9: -10},
    "AC03": {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1},
    "AC12": {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1},
    "DC": {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6,
           10: -6, 11: -8, 12: 42, 13: 152, 14: 42, 15: -8, 16: -6, 17: 6,
           18: 42, 19: 6, 20: -6, 21: -2, 22: -6, 23: -8, 24: -6, 25: -2},
}


def _weights(w: dict[int, int], transpose: bool = False) -> np.ndarray:
    out = np.zeros((5, 5), np.int64)
    for k, v in w.items():
        r, c = divmod(k - 1, 5)
        out[r, c] = v
    return (out.T if transpose else out).reshape(25)


# (zigzag index, DC-interpolation weights, other weights or None: not
# estimated then); a coefficient's transpose takes the transposed window
_ESTIMATES = [
    (1, _weights(_W["AC01"]), _weights(_W["AC01s"])),
    (2, _weights(_W["AC01"], True), _weights(_W["AC01s"], True)),
    (3, _weights(_W["AC20"]), _weights(_W["AC20s"])),
    (4, _weights(_W["AC11"]), _weights(_W["AC11s"])),
    (5, _weights(_W["AC20"], True), _weights(_W["AC20s"], True)),
    (6, _weights(_W["AC03"]), None),
    (7, _weights(_W["AC12"]), None),
    (8, _weights(_W["AC12"], True), None),
    (9, _weights(_W["AC03"], True), None),
]
_DC_WEIGHTS = _weights(_W["DC"])


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _entropy_segments(data: bytes, pos: int) -> list[bytes]:
    """The scan's entropy-coded bytes from ``pos``, unstuffed (``FF 00`` is
    the data byte ``FF``) and split at restart markers; another marker, or
    the end of the data, ends the scan. Fill bytes ``FF`` before a marker,
    and a lone ``FF`` at the end, are dropped, as libjpeg drops them."""
    segs, cur, n = [], bytearray(), len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            cur += data[pos:]
            break
        cur += data[pos:j]
        while j + 1 < n and data[j + 1] == 0xFF:
            j += 1
        if j + 1 >= n:
            break
        m = data[j + 1]
        pos = j + 2
        if m == 0:
            cur.append(0xFF)
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
        else:
            break
    segs.append(bytes(cur))
    return segs


def _windows(seg: bytes) -> list[int]:
    """Per byte of the segment (zeros after it), the 32 bits from it on."""
    a = np.frombuffer(seg + _ZERO_TAIL, np.uint8).astype(np.uint32)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()


def _lookup(counts: bytes, symbols: bytes) -> list[int]:
    """The next 16 bits of the stream -> ``code length << 8 | symbol``; a
    code not in the table takes 17 bits and reads as symbol 0, as
    libjpeg's ``jpeg_huff_decode`` reads it."""
    table = [17 << 8] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            if hi <= 65536:
                table[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            k += 1
            code += 1
        code <<= 1
    return table


def _scan_end(data: bytes, pos: int) -> int:
    """Where the marker after a scan's entropy-coded data starts (at its
    first ``FF``), or the data's length where the data ends first."""
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            return n
        k = j
        while k + 1 < n and data[k + 1] == 0xFF:
            k += 1
        if k + 1 >= n:
            return n
        if data[k + 1] != 0 and not 0xD0 <= data[k + 1] <= 0xD7:
            return j
        pos = k + 2


class _Progressive:
    """A cut progressive Huffman JPEG: its frame, the APP/COM segments
    before the frame, and each scan with the tables in force at its start.
    ``ok`` is False where the file is not covered."""

    def __init__(self, data: bytes):
        self.ok = False
        self.extra, self.scans = [], []
        if not data.startswith(b"\xff\xd8") or data.endswith(b"\xff\xd9"):
            return
        dht, dqt, restart, frame = {}, {}, 0, None
        n, pos = len(data), 2
        while True:
            while pos < n and data[pos] != 0xFF:
                pos += 1                        # stray bytes, as libjpeg skips
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                break                           # cut between segments
            marker = data[pos]
            pos += 1
            if marker in (_EOI, _SOI) or pos + 2 > n:
                return
            if marker == 0x01 or 0xD0 <= marker <= 0xD7:
                continue
            length = struct.unpack_from(">H", data, pos)[0]
            if length < 2 or pos + length > n:
                return                          # cut inside a segment
            body, end = data[pos + 2:pos + length], pos + length
            if marker == _SOS:
                scan = self._scan(body, frame, dht, dqt, restart)
                if scan is None:
                    return
                scan["segments"] = _entropy_segments(data, end)
                self.scans.append(scan)
                pos = _scan_end(data, end)
                continue
            if marker == _DHT:
                i = 0
                while i + 17 <= len(body):
                    counts = body[i + 1:i + 17]
                    stop = i + 17 + sum(counts)
                    if stop > len(body):
                        return
                    dht[(body[i] >> 4, body[i] & 15)] = _lookup(counts, body[i + 17:stop])
                    i = stop
            elif marker == _DQT:
                i = 0
                while i < len(body):
                    wide, tq = body[i] >> 4, body[i] & 15
                    size = 128 if wide else 64
                    if i + 1 + size > len(body):
                        return
                    q = np.zeros(64, np.int64)
                    q[_NATURAL] = np.frombuffer(body[i + 1:i + 1 + size],
                                                ">u2" if wide else np.uint8)
                    dqt[tq] = q
                    i += 1 + size
            elif marker == _DRI:
                restart = struct.unpack_from(">H", body)[0] if len(body) >= 2 else 0
            elif 0xC0 <= marker <= 0xCF and marker not in (0xC8, 0xCC):
                if marker != _PROGRESSIVE_HUFFMAN or frame is not None:
                    return
                if len(body) < 6 or body[0] != 8:
                    return                      # 12-bit: not covered
                h, w, nf = *struct.unpack_from(">HH", body, 1), body[5]
                if h == 0 or w == 0 or not 1 <= nf <= 4 or len(body) < 6 + 3 * nf:
                    return
                frame = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                          body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(nf)]
                self.height, self.width = h, w
            elif (0xE0 <= marker <= 0xEF or marker == _COM) and frame is None:
                self.extra.append(data[pos - 2:end])
            pos = end
        if frame is None or not self.scans:
            return
        self.comps = frame
        self.hmax = max(c[1] for c in frame)
        self.vmax = max(c[2] for c in frame)
        if any(not 1 <= c[1] <= 4 or not 1 <= c[2] <= 4 for c in frame):
            return
        self.mcus_x = _ceil_div(self.width, 8 * self.hmax)
        self.mcus_y = _ceil_div(self.height, 8 * self.vmax)
        # per component: the image's blocks (wide, high), and the array an
        # interleaved MCU grid fills (dummy blocks at the right and bottom)
        self.blocks = [(_ceil_div(_ceil_div(self.width * h, self.hmax), 8),
                        _ceil_div(_ceil_div(self.height * v, self.vmax), 8))
                       for _, h, v, _ in frame]
        self.padded = [(self.mcus_x * h, self.mcus_y * v) for _, h, v, _ in frame]
        # the quantization table each component latches at its first scan
        self.quant = [None] * len(frame)
        for scan in self.scans:
            for ci in scan["comps"]:
                if self.quant[ci] is None:
                    self.quant[ci] = scan["dqt"].get(frame[ci][3])
        if any(q is None for q in self.quant):
            return
        self.ok = True

    @staticmethod
    def _scan(body: bytes, frame, dht: dict, dqt: dict, restart: int):
        ns = body[0] if body else 0
        if frame is None or not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
            return None
        ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = a >> 4, a & 15
        if ss > se or se > 63 or (ss == 0) != (se == 0) or (ss and ns != 1) or al > 13:
            return None
        ids = [c[0] for c in frame]
        comps, tables = [], []
        for i in range(ns):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            if cid not in ids:
                return None
            comps.append(ids.index(cid))
            table = dht.get((0, t >> 4)) if ss == 0 else dht.get((1, t & 15))
            if table is None and not (ss == 0 and ah):
                return None
            tables.append(table)
        return dict(comps=comps, tables=tables, ss=ss, se=se, ah=ah, al=al,
                    restart=restart, dqt=dict(dqt))


def _decode_scan(img: _Progressive, scan: dict, coefs: list[list[int]]):
    """Decode one scan into ``coefs`` (per component, a flat list of the
    padded array's blocks, 64 natural-order coefficients each). Returns the
    iMCU row of the MCU the data ran out in, or None where every MCU had
    its bits."""
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    cis = scan["comps"]
    if len(cis) > 1:
        # interleaved (DC scans only): an MCU is each component's h x v blocks
        count = img.mcus_x * img.mcus_y
        per_mcu = [(k, ci, r, c) for k, ci in enumerate(cis)
                   for r in range(img.comps[ci][2]) for c in range(img.comps[ci][1])]

        def offsets(m):
            my, mx = divmod(m, img.mcus_x)
            return [(k, ci, ((my * img.comps[ci][2] + r) * img.padded[ci][0]
                             + mx * img.comps[ci][1] + c) * 64)
                    for k, ci, r, c in per_mcu]

        def imcu_row(m):
            return m // img.mcus_x
    else:
        ci = cis[0]
        bw, bh = img.blocks[ci]
        pw, v = img.padded[ci][0], img.comps[ci][2]
        count = bw * bh

        def offsets(m):
            return [(0, ci, ((m // bw) * pw + m % bw) * 64)]

        def imcu_row(m):
            return (m // bw) // v
    interval = scan["restart"] or count
    present = scan["segments"]
    short = None
    for s in range(_ceil_div(count, interval)):
        if s > len(present) or (s == len(present) and short is not None):
            break
        first = s * interval
        stop = min(first + interval, count)
        got = _decode_segment(
            scan, present[s] if s < len(present) else b"",
            [offsets(m) for m in range(first, stop)] if ss == 0 else None,
            (first, stop, offsets), coefs, ss, se, ah, al, len(cis))
        short = None if got is None else first + got
    return None if short is None else imcu_row(short)


def _decode_segment(scan, seg, dc_blocks, ac_range, coefs, ss, se, ah, al, ns):
    """Decode one restart segment's MCUs; returns the index (within the
    segment) of the MCU whose bits ran past the data, or None."""
    w = _windows(seg)
    total = 8 * len(seg)
    p = 0
    if ss == 0:
        if ah == 0:
            preds = [0] * ns
            tables = scan["tables"]
            for m, blocks in enumerate(dc_blocks):
                for k, ci, off in blocks:
                    e = tables[k][(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    size = e & 0xFF
                    if size:
                        v = (w[p >> 3] >> (32 - (p & 7) - size)) & ((1 << size) - 1)
                        p += size
                        preds[k] += v if v >> (size - 1) else v - (1 << size) + 1
                    coefs[ci][off] = preds[k] << al
                if p > total:
                    return m
            return None
        p1 = 1 << al
        for m, blocks in enumerate(dc_blocks):
            for k, ci, off in blocks:
                if (w[p >> 3] >> (31 - (p & 7))) & 1:
                    coefs[ci][off] |= p1
                p += 1
            if p > total:
                return m
        return None
    first, stop, offsets = ac_range
    table = scan["tables"][0]
    nat = _NATURAL_EXT
    eobrun = 0
    if ah == 0:
        for m in range(stop - first):
            if eobrun:
                eobrun -= 1
                continue
            (_, ci, off), = offsets(first + m)
            blk = coefs[ci]
            k = ss
            while k <= se:
                e = table[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    blk[off + nat[k]] = (v if v >> (s - 1) else v - (1 << s) + 1) << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
                k += 1
            if p > total:
                return m
        return None
    p1, m1 = 1 << al, -1 << al
    for m in range(stop - first):
        (_, ci, off), = offsets(first + m)
        blk = coefs[ci]
        k = ss
        if eobrun == 0:
            while k <= se:
                e = table[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    break
                while True:
                    i = off + nat[k]
                    c = blk[i]
                    if c:
                        if (w[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            blk[i] = c + p1 if c >= 0 else c + m1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if s:
                    blk[off + nat[k]] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                i = off + nat[k]
                c = blk[i]
                if c:
                    if (w[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                        blk[i] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1
        if p > total:
            return m
    return None


def coefficients(img: _Progressive):
    """Decode every scan: per component the padded (rows, cols, 64) int16
    coefficient array in natural order, libjpeg's ``coef_bits`` after the
    last scan's start and before each component's latest scan (zigzag
    0-63 each), and the iMCU row the last scan's data ran out in (None
    where it had all its bits)."""
    nc = len(img.comps)
    coefs = [[0] * (pw * ph * 64) for pw, ph in img.padded]
    bits = [[-1] * 64 for _ in range(nc)]
    prev = [[-1] * 64 for _ in range(nc)]
    row = None
    for number, scan in enumerate(img.scans, 1):
        for ci in scan["comps"]:
            for k in range(min(scan["ss"], 1), max(scan["se"], 9) + 1):
                prev[ci][k] = bits[ci][k] if number > 1 else 0
            for k in range(scan["ss"], scan["se"] + 1):
                bits[ci][k] = scan["al"]
        row = _decode_scan(img, scan, coefs)
    arrays = [((np.array(c, np.int64) + 32768) % 65536 - 32768).reshape(ph, pw, 64)
              for c, (pw, ph) in zip(coefs, img.padded)]
    return arrays, bits, prev, row


def _predict(num: np.ndarray, q: int, al: np.ndarray) -> np.ndarray:
    """jdcoefct.c's estimate from ``num`` for a coefficient quantized by
    ``q``: rounded, its magnitude held under ``1 << al`` where al > 0."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    cap = np.where(al > 0, (1 << np.maximum(al, 0)) - 1, np.iinfo(np.int64).max)
    return np.where(num >= 0, 1, -1) * np.minimum(mag, cap)


def smooth(img: _Progressive, arrays, bits, prev, last_good) -> list[np.ndarray]:
    """libjpeg-turbo's interblock smoothing (``decompress_smooth_data``)
    of the decoded arrays, where ``smoothing_ok`` allows it: the arrays the
    IDCT reads. iMCU rows past ``last_good`` take the status before each
    component's latest scan."""
    nc, total_rows = len(img.comps), img.mcus_y
    if any(bits[ci][0] < 0 for ci in range(nc)) or any(
            (img.quant[ci][_NATURAL[:_SAVED]] == 0).any() for ci in range(nc)):
        return arrays
    if not any(bits[ci][k] for ci in range(nc) for k in range(1, _SAVED)):
        return arrays
    several = len(img.scans) > 1
    out = []
    for ci, arr in enumerate(arrays):
        bw, bh = img.blocks[ci]
        v = img.comps[ci][2]
        q = img.quant[ci]
        cur = np.array(bits[ci][:_SAVED])
        old = np.array([bits[ci][0]] + [prev[ci][k] if several else -1
                                        for k in range(1, _SAVED)])
        rows = np.zeros((bh, 5), np.int64)
        late = np.zeros(bh, bool)
        for i in range(total_rows):
            block_rows = v if i < total_rows - 1 else (bh % v or v)
            image_rows = block_rows * total_rows
            for br in range(block_rows):
                r, ibr = i * v + br, i * block_rows + br
                p = r - 1 if ibr > 0 else r
                pp = r - 2 if ibr > 1 else p
                n = r + 1 if ibr < image_rows - 1 else r
                nn = r + 2 if ibr < image_rows - 2 else n
                rows[r] = (pp, p, r, n, nn)
                late[r] = last_good is not None and i > last_good
        cols = np.clip(np.arange(bw)[:, None] + np.arange(-2, 3), 0, bw - 1)
        dc = arr[:, :, 0].astype(np.int64)
        win = dc[rows[:, :, None, None], cols[None, None, :, :]]   # (bh, 5, bw, 5)
        win = win.transpose(0, 2, 1, 3).reshape(bh, bw, 25)
        status = np.where(late[:, None], old[None, :], cur[None, :])   # (bh, 10)
        change_dc = (status[:, 1:] == -1).all(axis=1)[:, None]         # (bh, 1)
        block = arr[:bh, :bw].copy()
        q00 = int(q[0])
        for j, w_dc, w_ac in _ESTIMATES:
            pos = int(_NATURAL[j])
            al = status[:, j][:, None]
            num = q00 * (win @ w_dc)
            if w_ac is not None:
                num = np.where(change_dc, num, q00 * (win @ w_ac))
                apply = al != 0
            else:
                apply = change_dc & (al != 0)
            apply = apply & (block[:, :, pos] == 0)
            block[:, :, pos] = np.where(apply, _predict(num, int(q[pos]), al),
                                        block[:, :, pos])
        num = q00 * (win @ _DC_WEIGHTS)
        block[:, :, 0] = np.where(change_dc, _predict(num, q00, np.zeros_like(num)),
                                  block[:, :, 0])
        block = (block + 32768) % 65536 - 32768
        smoothed = arr.copy()
        smoothed[:bh, :bw] = block
        out.append(smoothed)
    return out


def _codes(counts: bytes, symbols: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Each symbol's canonical Huffman code and its length (0: none)."""
    code_of, size_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            k += 1
            code += 1
        code <<= 1
    return code_of, size_of


def _category(a: np.ndarray) -> np.ndarray:
    """The bits of ``|a|`` (JPEG's magnitude category)."""
    return np.searchsorted(1 << np.arange(16), np.abs(a), side="right")


def _pack(values: np.ndarray, sizes: np.ndarray) -> bytes:
    """Bit fields, most significant bit first, padded with ones to a byte,
    ``FF`` bytes stuffed."""
    keep = sizes > 0
    values, sizes = values[keep], sizes[keep]
    total = int(sizes.sum())
    item = np.repeat(np.arange(len(sizes)), sizes)
    shift = sizes[item] - 1 - (np.arange(total) - np.repeat(np.cumsum(sizes) - sizes, sizes))
    bits = ((values[item] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def baseline(img: _Progressive, arrays) -> bytes:
    """The arrays as a baseline JPEG: SOI, the kept APP/COM segments, the
    quantization tables, SOF0, the Annex K Huffman tables, one scan of
    every component (interleaved MCUs over the padded arrays; a single
    component's scan covers its image blocks), EOI. Raises where a value
    lies outside what 8-bit baseline codes (an AC magnitude above 1023, a
    DC difference above 2047)."""
    nc = len(img.comps)
    blocks, comp = [], []
    if nc == 1:
        bw, bh = img.blocks[0]
        blocks = arrays[0][:bh, :bw].reshape(-1, 64)
        comp = np.zeros(len(blocks), np.int64)
    else:
        per = []
        for ci, (_, h, v, _) in enumerate(img.comps):
            a = arrays[ci].reshape(img.mcus_y, v, img.mcus_x, h, 64)
            per.append(a.transpose(0, 2, 1, 3, 4).reshape(img.mcus_y * img.mcus_x, v * h, 64))
            comp.append(np.full(v * h, ci))
        blocks = np.concatenate(per, axis=1).reshape(-1, 64)
        comp = np.tile(np.concatenate(comp), img.mcus_y * img.mcus_x)
    zz = blocks[:, _NATURAL].astype(np.int64)
    nb = len(zz)
    table = (comp > 0).astype(np.int64)
    # DC differences, per component in scan order
    diff = np.empty(nb, np.int64)
    for ci in range(nc):
        idx = np.nonzero(comp == ci)[0]
        diff[idx] = np.diff(zz[idx, 0], prepend=0)
    b_idx, k = np.nonzero(zz[:, 1:])
    k = k + 1
    val = zz[b_idx, k]
    if (np.abs(diff) > 2047).any() or (np.abs(val) > 1023).any():
        raise ValueError("jpeg_coef.baseline: a coefficient lies outside "
                         "8-bit baseline's range")
    dc_codes = [_codes(*t) for t in _K_DC]
    ac_codes = [_codes(*t) for t in _K_AC]
    dc_code = np.stack([c for c, _ in dc_codes])
    dc_size = np.stack([s for _, s in dc_codes])
    ac_code = np.stack([c for c, _ in ac_codes])
    ac_size = np.stack([s for _, s in ac_codes])
    # the previous nonzero coefficient's index within the block (0 at its start)
    first = np.ones(len(k), bool)
    first[1:] = b_idx[1:] != b_idx[:-1]
    before = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - before - 1
    zrl, run = run // 16, run % 16
    size = _category(val)
    sym = (run << 4) | size
    tb = table[b_idx]
    mag = np.where(val >= 0, val, val + (1 << size) - 1)
    dsize = _category(diff)
    dmag = np.where(diff >= 0, diff, diff + (1 << dsize) - 1)
    last = np.zeros(nb, np.int64)
    last[b_idx] = k                 # nonzero indices ascend within a block
    eob = last < 63
    # items in stream order: key = block * 256 + slot
    zrl_item = np.repeat(np.arange(len(k)), zrl)
    keys = np.concatenate([
        np.arange(nb) * 256, np.arange(nb) * 256 + 1,
        b_idx[zrl_item] * 256 + 2 + 3 * k[zrl_item],
        b_idx * 256 + 3 + 3 * k, b_idx * 256 + 4 + 3 * k,
        np.arange(nb) * 256 + 255])
    values = np.concatenate([
        dc_code[table, dsize], dmag,
        ac_code[tb[zrl_item], 0xF0],
        ac_code[tb, sym], mag,
        ac_code[table, 0]])
    sizes = np.concatenate([
        dc_size[table, dsize], dsize,
        ac_size[tb[zrl_item], 0xF0],
        ac_size[tb, sym], size,
        np.where(eob, ac_size[table, 0], 0)])
    order = np.argsort(keys, kind="stable")
    entropy = _pack(values[order], sizes[order])
    out = bytearray(b"\xff\xd8")
    for seg in img.extra:
        out += seg
    for tq in sorted({c[3] for c in img.comps}):
        q = img.quant[[c[3] for c in img.comps].index(tq)][_NATURAL]
        wide = int((q > 255).any())
        body = bytes([wide << 4 | tq]) + (q.astype(">u2").tobytes() if wide
                                          else q.astype(np.uint8).tobytes())
        out += b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
    sof = struct.pack(">BHHB", 8, img.height, img.width, nc) + b"".join(
        bytes([cid, h << 4 | v, tq]) for cid, h, v, tq in img.comps)
    wide = any((q > 255).any() for q in img.quant)
    out += (b"\xff\xc1" if wide else b"\xff\xc0") + struct.pack(">H", len(sof) + 2) + sof
    for tc, tables in ((0, _K_DC), (1, _K_AC)):
        for th, (counts, symbols) in enumerate(tables[:1 if nc == 1 else 2]):
            body = bytes([tc << 4 | th]) + counts + symbols
            out += b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body
    sos = bytes([nc]) + b"".join(bytes([cid, 0 if ci == 0 else 0x11])
                                 for ci, (cid, _, _, _) in enumerate(img.comps))
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    return bytes(out) + entropy + b"\xff\xd9"


def transcode(data: bytes) -> bytes | None:
    """A cut progressive JPEG as the baseline JPEG of the coefficients
    libjpeg's IDCT reads for it (module docstring); None where the file is
    not covered."""
    img = _Progressive(data)
    if not img.ok:
        return None
    arrays, bits, prev, row = coefficients(img)
    return baseline(img, smooth(img, arrays, bits, prev,
                                img.mcus_y - 1 if row is None else row))
