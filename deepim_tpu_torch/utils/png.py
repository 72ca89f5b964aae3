"""PNG reading and writing with zlib and numpy, so the port needs no image
package.

read_png decodes non-interlaced 8-bit gray, 8-bit RGB, 8-bit RGBA and
16-bit gray images (the colour, label and depth files of a LINEMOD-layout
devkit) and returns them as stored: RGB order, 16-bit samples as native
uint16.  Any other colour type or bit depth, and interlaced images, raise.

Rows filtered with None, Sub or Up decode as whole-row numpy operations.
Average and Paeth predict each byte from the byte just decoded to its
left, so those rows decode byte by byte in Python: slow (of the order of a
second for a 480x640 RGB image), and what files written with adaptive
filtering (cv2, libpng's default) mostly hold.  write_png writes filter 0
by default, which decodes at the speed of zlib.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> channels
_FORMATS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: corrupt {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw (height, 1 + stride) uint8 ->
    (height, stride) uint8."""
    ftypes = raw[:, 0]
    if not ftypes.any():
        return raw[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ft, row = int(ftypes[y]), raw[y, 1:]
        if ft == 0:
            cur = row
        elif ft == 1:  # Sub: cumulative sum of each channel along the row (uint8 wraps)
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif ft == 2:  # Up
            cur = row + prev
        elif ft in (3, 4):
            cur = np.frombuffer(bytes(_average_or_paeth(ft, row.tolist(), prev.tolist(), bpp)),
                                np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {ft}")
        out[y] = cur
        prev = out[y]
    return out


def _average_or_paeth(ft: int, x: list, b: list, bpp: int) -> list:
    """Average (3) or Paeth (4) row decode, byte by byte; x is the row's
    filtered bytes (decoded in place), b the decoded row above."""
    if ft == 3:
        for i in range(bpp):
            x[i] = (x[i] + (b[i] >> 1)) & 255
        for i in range(bpp, len(x)):
            x[i] = (x[i] + ((x[i - bpp] + b[i]) >> 1)) & 255
        return x
    for i in range(bpp):
        x[i] = (x[i] + b[i]) & 255  # a = c = 0: Paeth picks b
    for i in range(bpp, len(x)):
        a, bb, c = x[i - bpp], b[i], b[i - bpp]
        pa, pb, pc = abs(bb - c), abs(a - c), abs(a + bb - 2 * c)
        x[i] = (x[i] + (a if pa <= pb and pa <= pc else bb if pb <= pc else c)) & 255
    return x


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) uint8 or uint16 for gray, (H, W, 3) uint8 RGB,
    (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, compression, filt, interlace = header
    if (color, depth) not in _FORMATS:
        raise ValueError(f"{path}: colour type {color} at bit depth {depth} is not supported "
                         "(8-bit gray, RGB, RGBA and 16-bit gray are)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if compression or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    channels = _FORMATS[color, depth]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, want {height * (stride + 1)}")
    pix = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        return pix.reshape(height, width * 2).view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return np.ascontiguousarray(pix).reshape(shape)


def _filter_rows(x: np.ndarray, ft: int, bpp: int) -> np.ndarray:
    """Filter every row of x ((H, stride) uint8) with filter type ft."""
    xi = x.astype(np.int16)
    a = np.zeros_like(xi)
    a[:, bpp:] = xi[:, :-bpp]
    b = np.zeros_like(xi)
    b[1:] = xi[:-1]
    c = np.zeros_like(xi)
    c[:, bpp:] = b[:, :-bpp]
    if ft == 0:
        pred = np.zeros_like(xi)
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = b
    elif ft == 3:
        pred = (a + b) >> 1
    elif ft == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type must be 0-4, got {ft}")
    return ((xi - pred) & 255).astype(np.uint8)


def encode_png(array: np.ndarray, filter_type: int = 0) -> bytes:
    """The PNG file of `array`, as bytes: (H, W) uint8 or uint16 gray,
    (H, W, 3) uint8 RGB or (H, W, 4) uint8 RGBA.  Every row gets
    `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); zlib
    compresses at level 1, fast to write and to read."""
    arr = np.asarray(array)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        depth, channels = 16, 1
        rows = arr.astype(">u2").view(np.uint8).reshape(arr.shape[0], -1)
    elif arr.dtype == np.uint8 and (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (3, 4))):
        depth, channels = 8, 1 if arr.ndim == 2 else arr.shape[2]
        rows = arr.reshape(arr.shape[0], -1)
    else:
        raise ValueError(f"encode_png takes uint8 gray/RGB/RGBA or uint16 gray, got {arr.dtype} {arr.shape}")
    height, width = arr.shape[:2]
    bpp = channels * depth // 8
    filtered = _filter_rows(rows, filter_type, bpp)
    body = np.concatenate([np.full((height, 1), filter_type, np.uint8), filtered], axis=1)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    header = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(body.tobytes(), 1))
            + chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray, filter_type: int = 0) -> None:
    """Write `array` to `path` as encode_png encodes it."""
    data = encode_png(array, filter_type)
    with open(path, "wb") as f:
        f.write(data)
