"""JPEG decoding in numpy: the port's counterpart of cv2.imread on JPEG
files, so the port needs no image package.

decode_jpeg and read_jpeg decode Huffman-coded 8-bit files, sequential
(SOF0, SOF1) or progressive (SOF2), with one component (gray), three
(YCbCr, or RGB where an Adobe marker or the component ids say so) or four
(CMYK, or YCCK where an Adobe marker's transform is not 0), any integer
sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1) on sizes that are not
a multiple of the MCU, interleaved or per-component scans, restart
intervals (DRI, RSTn) and byte stuffing.  Progressive scans are DC first
and refinement scans, AC spectral selection and successive-approximation
refinement with EOB runs, all kept in one whole-image coefficient array,
so a complete progressive file yields the quantised coefficients of its
baseline twin and the same pixels.  APPn and COM segments are skipped.

Two modes, as cv2.imread's: "color" (IMREAD_COLOR) returns (H, W, 3) uint8
RGB (gray repeated to three channels) with an Exif orientation applied as
cv2 applies it; "unchanged" (IMREAD_UNCHANGED) returns gray as (H, W),
everything else as (H, W, 3) RGB, and applies no orientation.  Four
components convert as cv2 converts libjpeg's CMYK output (YCCK first goes
to CMYK by libjpeg's ycck_cmyk_convert): each of C, M, Y becomes
k - ((255 - x) * k >> 8), giving R, G, B.

Lossless (SOF3), arithmetic-coded (SOF9-SOF15, DAC), hierarchical and
12-bit files raise ValueError naming the file and its kind.  So does a
progressive file whose scans leave bits of the DC or the first nine AC
coefficients of a component unknown (a scan script that stops short):
libjpeg-turbo then smooths the blocks (jdcoefct.c decompress_smooth_data),
which this module does not reproduce.

The arithmetic is libjpeg-turbo's default decompression, which cv2 uses:
the ISLOW integer IDCT (jidctint.c) with its range-limit table, "fancy"
triangle upsampling for h2v1, h2v2 and h1v2 chroma (jdsample.c; box
replication for the other factors and for chroma 2 samples wide or
narrower) and the fixed-point YCbCr -> RGB tables (jdcolor.c).  The result
equals cv2.imread's bit for bit (tests/test_torch_jpeg.py,
tests/test_torch_imread.py).

Huffman codes are read through a 65,536-entry lookup table indexed by the
next 16 bits of the stream, each symbol and its extra bits from one 32-bit
window (computed for every bit position of the scan at once); the entropy
decoding is Python over those lists, the IDCT, upsampling and colour
conversion run over all blocks at once.
"""
from __future__ import annotations

import re
import struct

import numpy as np

# Natural (row-major) index of each zig-zag position, padded as libjpeg's
# jpeg_natural_order is, so a corrupt run length cannot index past it.
_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16
_MASK = [(1 << s) - 1 for s in range(17)]
_HALF = [1 << (s - 1) if s else 0 for s in range(17)]

_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential", 0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}
MODES = ("color", "unchanged")  # cv2.imread's IMREAD_COLOR and IMREAD_UNCHANGED
# libjpeg-turbo's block smoothing looks at the DC and the first nine AC
# coefficients (jdcoefct.c SAVED_COEFS).
_SMOOTHED = 10
_SCAN_END = re.compile(rb"\xff(?![\x00\xd0-\xd7\xff])")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")

# jidctint.c: CONST_BITS 13, PASS1_BITS 2 and its FIX() constants.
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0_298, _F0_390, _F0_541, _F0_765, _F0_899, _F1_175, _F1_501, _F1_847, _F1_961, _F2_053, _F2_562,
 _F3_072) = 2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172


def _idct_range_limit() -> np.ndarray:
    """libjpeg's sample_range_limit table seen from IDCT_range_limit
    (jdmaster.c prepare_range_limit_table), indexed by an IDCT output
    & RANGE_MASK (1023): the output + 128 clamped to [0, 255] for outputs
    in [-512, 511], wrapping beyond as libjpeg's table does."""
    table = np.zeros(5 * 256 + 128, np.uint8)
    base = 256
    table[base:base + 256] = np.arange(256)
    table[base + 256:base + 128 + 512] = 255
    post = base + 128  # IDCT_range_limit
    table[post + 4 * 256 - 128:post + 4 * 256] = table[base:base + 128]
    return table[post:post + 1024].copy()


_RANGE_LIMIT = _idct_range_limit()


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: Cr->R, Cb->B, and the two G terms,
    16-bit fixed point."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.base = 0             # offset of its first coefficient in the flat store
        self.blocks_w = self.blocks_h = 0   # allocated blocks (whole MCUs)
        self.width = self.height = 0        # downsampled size in samples
        self.coef_bits = [-1] * 64  # progressive: lowest bit yet known of each zig-zag coefficient, -1 none


def _huffman_table(counts: bytes, symbols: bytes, name: str) -> list:
    """(code length << 8 | symbol) for every 16-bit prefix; 0 where no code
    starts (a corrupt stream)."""
    table = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols) or code >= (1 << length):
                raise ValueError(f"{name}: corrupt Huffman table")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _windows(data: bytes) -> list:
    """The 32 bits starting at every bit position of `data` (zeros past its
    end), as Python ints."""
    b = np.frombuffer(data + bytes(8), np.uint8).astype(np.uint64)
    n = len(data)
    w40 = (b[:n + 1] << 32) | (b[1:n + 2] << 24) | (b[2:n + 3] << 16) | (b[3:n + 4] << 8) | b[4:n + 5]
    shifts = np.arange(8, 0, -1, dtype=np.uint64)
    return ((w40[:, None] >> shifts[None, :]) & np.uint64(0xFFFFFFFF)).ravel().tolist()


def _exif_orientation(seg: bytes) -> int:
    """Orientation tag of an APP1 Exif segment, 1 if absent."""
    if not seg.startswith(b"Exif\x00\x00"):
        return 1
    return tiff_orientation(seg[6:])


def tiff_orientation(tiff: bytes) -> int:
    """Orientation tag (0x0112) in IFD0 of Exif's TIFF structure (an APP1
    segment's body after its "Exif" header, a PNG eXIf chunk), 1 if
    absent."""
    if len(tiff) < 8:
        return 1
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    (ifd,) = struct.unpack(order + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, typ = struct.unpack(order + "HH", tiff[at:at + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(order + "H", tiff[at + 8:at + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform for orientations 1-8 (others leave the image)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        img = np.flip(img, axis=flip)
    return np.ascontiguousarray(img)


def _idct_pass(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One pass of jpeg_idct_islow along `axis` (1: pass 1 over columns, 2:
    pass 2 over rows) of (N, 8, 8) int64, each output descaled by `shift`."""
    c = [np.take(x, k, axis=axis) for k in range(8)]
    z1 = (c[2] + c[6]) * _F0_541
    tmp2 = z1 - c[6] * _F1_847
    tmp3 = z1 + c[2] * _F0_765
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0, t1, t2, t3 = t0 * _F0_298, t1 * _F2_053, t2 * _F3_072, t3 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + half) >> shift for o in outs], axis=axis)


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(N, 64) quantised coefficients (natural order) -> (N, 8, 8) uint8."""
    x = (coef.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_pass(x, 1, _CONST_BITS - _PASS1_BITS)
    out = _idct_pass(ws, 2, _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[out & 1023]


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (h, w) downsampled plane by (fh, fv):
    the triangle filters for h2v1 and h2v2 when the plane is wider than 2
    samples and for h1v2, box replication otherwise.  The edges repeat the
    first and last real row and column, which is what libjpeg's context
    rows and edge columns compute."""
    if fh == 1 and fv == 1:
        return plane
    x = plane.astype(np.int32)
    w = x.shape[1]
    if fv == 2 and (fh == 1 or (fh == 2 and w > 2)):
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        if fh == 1:
            rows = [(3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2]
        else:
            rows = []
            for col in (3 * x + above, 3 * x + below):  # column sums of the upper and the lower output row
                left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
                right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
                even, odd = (3 * col + left + 8) >> 4, (3 * col + right + 7) >> 4
                rows.append(np.stack([even, odd], axis=2).reshape(col.shape[0], -1))
        return np.stack(rows, axis=1).reshape(-1, rows[0].shape[1]).astype(np.uint8)
    if fh == 2 and fv == 1 and w > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        even, odd = (3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2
        return np.stack([even, odd], axis=2).reshape(x.shape[0], -1).astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _ycck_to_cmyk(y, cb, cr, k) -> list:
    """jdcolor.c ycck_cmyk_convert: each colour channel is 255 minus the
    YCbCr -> RGB value, clamped; K passes through."""
    return [255 - c for c in np.moveaxis(_ycc_to_rgb(y, cb, cr), -1, 0)] + [k]


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """cv2's conversion of libjpeg's CMYK output: x -> k - ((255 - x) * k >> 8)."""
    k = k.astype(np.int32)
    return np.stack([k - (((255 - x.astype(np.int32)) * k) >> 8) for x in (c, m, y)], axis=-1).astype(np.uint8)


class _Decoder:
    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        self.qt: dict[int, np.ndarray] = {}
        self.dc: dict[int, list] = {}
        self.ac: dict[int, list] = {}
        self.restart = 0
        self.comps: list[_Component] = []
        self.coef: list | None = None
        self.progressive = False
        self.jfif = False
        self.adobe_transform: int | None = None
        self.orientation = 1

    def error(self, what: str) -> ValueError:
        return ValueError(f"{self.name}: {what}")

    def decode(self, mode: str) -> np.ndarray:
        data = self.data
        if data[:2] != b"\xff\xd8":
            raise self.error("not a JPEG file (no SOI marker)")
        pos = 2
        while True:
            while pos < len(data) and data[pos] != 0xFF:
                pos += 1  # garbage between segments: libjpeg skips it too
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                raise self.error("truncated JPEG file (no EOI marker)")
            marker = data[pos]
            pos += 1
            if marker == 0xD9:
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            if pos + 2 > len(data):
                raise self.error("truncated JPEG file")
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            seg = data[pos + 2:pos + length]
            if len(seg) != length - 2:
                raise self.error("truncated JPEG segment")
            pos += length
            if marker in (0xC0, 0xC1, 0xC2):
                self.frame(seg, progressive=marker == 0xC2)
            elif marker in _UNSUPPORTED_SOF:
                raise self.error(f"{_UNSUPPORTED_SOF[marker]} JPEG (SOF{marker - 0xC0}) is not supported: "
                                 "Huffman-coded sequential and progressive files only")
            elif marker == 0xCC:
                raise self.error("arithmetic-coded JPEG (DAC) is not supported")
            elif marker == 0xC4:
                self.huffman(seg)
            elif marker == 0xDB:
                self.quant(seg)
            elif marker == 0xDD:
                (self.restart,) = struct.unpack(">H", seg[:2])
            elif marker == 0xDA:
                pos = self.scan(seg, pos)
            elif marker == 0xE0 and seg.startswith(b"JFIF\x00"):
                self.jfif = True
            elif marker == 0xE1 and self.orientation == 1:
                self.orientation = _exif_orientation(seg)
            elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
                self.adobe_transform = seg[11]
        if self.coef is None:
            raise self.error("JPEG file holds no image data")
        if self.progressive:
            self.check_no_smoothing()
        img = self.output()
        if mode == "unchanged":
            return img[:, :, 0].copy() if len(self.comps) == 1 else img
        return apply_orientation(img, self.orientation)

    def frame(self, seg: bytes, progressive: bool) -> None:
        if self.comps:
            raise self.error("more than one frame")
        precision, height, width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise self.error(f"{precision}-bit JPEG is not supported (8-bit only)")
        if height == 0 or width == 0:
            raise self.error("JPEG with a zero (DNL-defined) size is not supported")
        if n not in (1, 3, 4):
            raise self.error(f"JPEG with {n} components is not supported (1, 3 or 4)")
        self.height, self.width, self.progressive = height, width, progressive
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise self.error("bad sampling factors")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        base = 0
        for c in self.comps:
            c.blocks_w, c.blocks_h = self.mcux * c.h, self.mcuy * c.v
            c.width = -(-width * c.h // self.hmax)
            c.height = -(-height * c.v // self.vmax)
            c.base = base
            base += c.blocks_w * c.blocks_h * 64
        self.coef = [0] * base

    def huffman(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            tc_th = seg[pos]
            counts = seg[pos + 1:pos + 17]
            n = sum(counts)
            symbols = seg[pos + 17:pos + 17 + n]
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = _huffman_table(counts, symbols, self.name)
            pos += 17 + n

    def quant(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            dtype, size = (">u2", 128) if pq else ("u1", 64)
            zz = np.frombuffer(seg[pos + 1:pos + 1 + size], dtype).astype(np.int64)
            table = np.zeros(64, np.int64)
            table[_ZIGZAG[:64]] = zz
            self.qt[tq] = table
            pos += 1 + size

    def table(self, tables: dict, index: int) -> list:
        if index not in tables:
            raise self.error("scan uses an undefined Huffman table")
        return tables[index]

    def scan(self, seg: bytes, pos: int) -> int:
        """Decode one scan whose entropy-coded data starts at `pos`; returns
        the position of the marker that ends it."""
        if not self.comps:
            raise self.error("scan before the frame header")
        ns = seg[0]
        by_id = {c.id: c for c in self.comps}
        comps, tds, tas = [], [], []
        for i in range(ns):
            cs, td_ta = seg[1 + 2 * i:3 + 2 * i]
            if cs not in by_id:
                raise self.error(f"scan names an unknown component {cs}")
            comps.append(by_id[cs])
            tds.append(td_ta >> 4)
            tas.append(td_ta & 15)
        ss, se, ah_al = seg[1 + 2 * ns:4 + 2 * ns]
        ah, al = ah_al >> 4, ah_al & 15
        end_m = _SCAN_END.search(self.data, pos)
        end = end_m.start() if end_m else len(self.data)
        segments = [s.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
                    for s in _RESTART.split(self.data[pos:end])]
        starts, offset = [], 0
        for s in segments:
            starts.append(offset)
            offset += 8 * len(s)
        win = _windows(b"".join(segments))

        # Each block's coefficient offset and scan component, in decode order.
        if ns == 1:
            c = comps[0]
            bh, bw = -(-c.height // 8), -(-c.width // 8)
            by, bx = np.divmod(np.arange(bh * bw), bw)
            bases = (c.base + (by * c.blocks_w + bx) * 64)[:, None]
            slots = [0]
        else:
            my, mx = np.divmod(np.arange(self.mcux * self.mcuy), self.mcux)
            cols, slots = [], []
            for j, c in enumerate(comps):
                for v in range(c.v):
                    for h in range(c.h):
                        cols.append(c.base + (((my * c.v + v) * c.blocks_w) + mx * c.h + h) * 64)
                        slots.append(j)
            bases = np.stack(cols, axis=1)
        blocks = (win, starts, bases.ravel().tolist(), slots * bases.shape[0], self.restart * len(slots))
        if not self.progressive:
            self._sequential(*blocks, [self.table(self.dc, t) for t in tds],
                             [self.table(self.ac, t) for t in tas], ns)
            return end
        if not (ss <= se <= 63 and (ss == 0) == (se == 0)) or (ss and ns != 1) or ah > 13 or al > 13:
            raise self.error(f"bad progressive scan (Ss {ss}, Se {se}, Ah {ah}, Al {al}, {ns} components)")
        for c in comps:
            c.coef_bits[ss:se + 1] = [al] * (se - ss + 1)
        try:
            if ss == 0 and ah == 0:
                self._dc_first(*blocks, [self.table(self.dc, t) for t in tds], ns, al)
            elif ss == 0:
                self._dc_refine(*blocks, al)
            elif ah == 0:
                self._ac_first(*blocks, self.table(self.ac, tas[0]), ss, se, al)
            else:
                self._ac_refine(*blocks, self.table(self.ac, tas[0]), ss, se, al)
        except IndexError:
            raise self.error("corrupt JPEG data (entropy-coded data ends early)") from None
        return end

    def _sequential(self, win, starts, bases, slots, ri, dcs, acs, ns) -> None:
        coef, zz, mask, half = self.coef, _ZIGZAG, _MASK, _HALF
        pred = [0] * ns
        pos, seg = 0, 0
        try:
            for i in range(len(bases)):
                if ri and i and i % ri == 0:
                    seg += 1
                    if seg < len(starts):
                        pos = starts[seg]
                    pred = [0] * ns
                base, j = bases[i], slots[i]
                w = win[pos]
                e = dcs[j][w >> 16]
                if not e:
                    raise self.error("corrupt JPEG data (bad Huffman code)")
                n, s = e >> 8, e & 15
                if s:
                    v = (w >> (32 - n - s)) & mask[s]
                    if v < half[s]:
                        v -= mask[s]
                    pred[j] += v
                    n += s
                pos += n
                coef[base] = pred[j]
                ac = acs[j]
                k = 1
                while k < 64:
                    w = win[pos]
                    e = ac[w >> 16]
                    if not e:
                        raise self.error("corrupt JPEG data (bad Huffman code)")
                    n, rs = e >> 8, e & 255
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        v = (w >> (32 - n - s)) & mask[s]
                        if v < half[s]:
                            v -= mask[s]
                        coef[base + zz[k]] = v
                        pos += n + s
                        k += 1
                    else:
                        pos += n
                        if rs != 0xF0:
                            break
                        k += 16
        except IndexError:
            raise self.error("corrupt JPEG data (entropy-coded data ends early)") from None

    # Progressive scans (jdphuff.c).  At a restart marker the DC predictions
    # and the EOB run reset and reading moves to the next interval's data.

    def _dc_first(self, win, starts, bases, slots, ri, dcs, ns, al) -> None:
        coef, mask, half = self.coef, _MASK, _HALF
        pred = [0] * ns
        pos, seg = 0, 0
        for i in range(len(bases)):
            if ri and i and i % ri == 0:
                seg += 1
                pos = starts[seg] if seg < len(starts) else pos
                pred = [0] * ns
            j = slots[i]
            w = win[pos]
            e = dcs[j][w >> 16]
            if not e:
                raise self.error("corrupt JPEG data (bad Huffman code)")
            n, s = e >> 8, e & 15
            if s:
                v = (w >> (32 - n - s)) & mask[s]
                if v < half[s]:
                    v -= mask[s]
                pred[j] += v
                n += s
            pos += n
            coef[bases[i]] = pred[j] << al

    def _dc_refine(self, win, starts, bases, slots, ri, al) -> None:
        coef, p1 = self.coef, 1 << al
        pos, seg = 0, 0
        for i in range(len(bases)):
            if ri and i and i % ri == 0:
                seg += 1
                pos = starts[seg] if seg < len(starts) else pos
            if win[pos] >> 31:
                coef[bases[i]] |= p1
            pos += 1

    def _ac_first(self, win, starts, bases, slots, ri, ac, ss, se, al) -> None:
        coef, zz, mask, half = self.coef, _ZIGZAG, _MASK, _HALF
        pos, seg, eobrun = 0, 0, 0
        for i in range(len(bases)):
            if ri and i and i % ri == 0:
                seg += 1
                pos = starts[seg] if seg < len(starts) else pos
                eobrun = 0
            if eobrun:
                eobrun -= 1
                continue
            base = bases[i]
            k = ss
            while k <= se:
                w = win[pos]
                e = ac[w >> 16]
                if not e:
                    raise self.error("corrupt JPEG data (bad Huffman code)")
                n, rs = e >> 8, e & 255
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    v = (w >> (32 - n - s)) & mask[s]
                    if v < half[s]:
                        v -= mask[s]
                    coef[base + zz[k]] = v << al
                    pos += n + s
                elif r == 15:
                    pos += n
                    k += 15
                else:
                    eobrun = (1 << r) + ((w >> (32 - n - r)) & mask[r]) - 1 if r else 0
                    pos += n + r
                    break
                k += 1

    def _ac_refine(self, win, starts, bases, slots, ri, ac, ss, se, al) -> None:
        coef, zz, mask = self.coef, _ZIGZAG, _MASK
        p1, m1 = 1 << al, -1 << al
        band = zz[ss:se + 1]
        pos, seg, eobrun = 0, 0, 0
        for i in range(len(bases)):
            if ri and i and i % ri == 0:
                seg += 1
                pos = starts[seg] if seg < len(starts) else pos
                eobrun = 0
            base = bases[i]
            k = ss
            if not eobrun:
                while k <= se:
                    w = win[pos]
                    e = ac[w >> 16]
                    if not e:
                        raise self.error("corrupt JPEG data (bad Huffman code)")
                    n, rs = e >> 8, e & 255
                    r, s = rs >> 4, rs & 15
                    pos += n
                    if s:
                        s = p1 if win[pos] >> 31 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = (1 << r) + ((win[pos] >> (32 - r)) & mask[r]) if r else 1
                        pos += r
                        break
                    # Append correction bits to the nonzero coefficients up
                    # to the r-th zero one (the new coefficient's place).
                    while k <= se:
                        at = base + zz[k]
                        c = coef[at]
                        if c:
                            if win[pos] >> 31 and not c & p1:
                                coef[at] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        elif r:
                            r -= 1
                        else:
                            break
                        k += 1
                    if s:
                        coef[base + zz[k]] = s
                    k += 1
            if eobrun:
                # The rest of the band lies in the EOB run: a correction bit
                # for each nonzero coefficient.
                for z in band[k - ss:]:
                    c = coef[base + z]
                    if c:
                        if win[pos] >> 31 and not c & p1:
                            coef[base + z] = c + p1 if c >= 0 else c + m1
                        pos += 1
                eobrun -= 1

    def check_no_smoothing(self) -> None:
        """Raise where libjpeg-turbo would smooth the blocks (jdcoefct.c
        smoothing_ok): every component's DC at least partly known, the DC
        and first nine AC quantisers nonzero, and some of those AC
        coefficients not known to their last bit."""
        for c in self.comps:
            q = self.qt.get(c.tq)
            if q is None or not all(q[_ZIGZAG[k]] for k in range(_SMOOTHED)) or c.coef_bits[0] < 0:
                return
        gaps = {c.id: c.coef_bits[:_SMOOTHED] for c in self.comps if any(c.coef_bits[1:_SMOOTHED])}
        if gaps:
            raise self.error("progressive JPEG whose scans leave low-frequency coefficient bits unknown "
                             f"(lowest known bit of zig-zag coefficients 0-9 by component: {gaps}; -1 never "
                             "sent): cv2's libjpeg-turbo smooths such blocks, which this decoder does not "
                             "reproduce")

    def colour_space(self) -> str:
        """jdapimin.c default_decompress_parms for three and four components."""
        if len(self.comps) == 4:
            return "ycck" if self.adobe_transform not in (None, 0) else "cmyk"
        if self.jfif:
            return "ycc"
        if self.adobe_transform is not None:
            return "rgb" if self.adobe_transform == 0 else "ycc"
        ids = [c.id for c in self.comps]
        return "rgb" if ids == [82, 71, 66] else "ycc"

    def output(self) -> np.ndarray:
        """(H, W, 3) uint8 RGB, gray repeated, before any orientation."""
        coef = np.array(self.coef, np.int32).reshape(-1, 64)
        planes = []
        for c in self.comps:
            if c.tq not in self.qt:
                raise self.error(f"component {c.id} uses an undefined quantisation table")
            nb = c.blocks_w * c.blocks_h
            blocks = _idct_islow(coef[c.base // 64:c.base // 64 + nb], self.qt[c.tq])
            plane = blocks.reshape(c.blocks_h, c.blocks_w, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(c.blocks_h * 8, c.blocks_w * 8)[:c.height, :c.width]
            if self.hmax % c.h or self.vmax % c.v:
                raise self.error("non-integral sampling ratios are not supported")
            planes.append(_upsample(plane, self.hmax // c.h, self.vmax // c.v)[:self.height, :self.width])
        if len(planes) == 1:
            return np.repeat(planes[0][:, :, None], 3, axis=2)
        space = self.colour_space()
        if space == "rgb":
            return np.stack(planes, axis=-1)
        if space == "ycc":
            return _ycc_to_rgb(*planes)
        if space == "ycck":
            planes = _ycck_to_cmyk(*planes)
        return _cmyk_to_rgb(*planes)


def decode_jpeg(data: bytes, name: str = "<bytes>", mode: str = "color") -> np.ndarray:
    """JPEG bytes -> the array cv2.imread gives in `mode` ("color" or
    "unchanged"), colour channels in RGB order (see the module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return _Decoder(data, name).decode(mode)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> (H, W, 3) uint8 RGB, cv2.imread(path,
    IMREAD_COLOR)[..., ::-1]."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
