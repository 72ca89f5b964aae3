"""PNG reading and writing with zlib and numpy, so the port needs no image
package.

decode_png and read_png decode every PNG the specification defines: colour
types 0 (gray at 1, 2, 4, 8 and 16 bits), 2 (RGB, 8 and 16), 3 (palette at
1, 2, 4 and 8), 4 (gray + alpha, 8 and 16) and 6 (RGBA, 8 and 16), with or
without a tRNS chunk, plain or Adam7-interlaced.  Each of the two modes
returns what cv2.imread (libpng 1.6) returns in its mode, with colour
channels in RGB(A) order rather than cv2's BGR(A):

  "unchanged" (IMREAD_UNCHANGED): gray (H, W), RGB (H, W, 3), RGBA and gray
      + alpha (H, W, 4) (gray repeated into the three colour channels), a
      palette expanded to (H, W, 3), or (H, W, 4) with its tRNS alphas (255
      past the listed entries); RGB with tRNS gains an alpha channel, 0
      where a pixel equals the tRNS colour and the depth's maximum
      elsewhere; gray ignores its tRNS.  16-bit files give uint16, all
      others uint8.
  "color" (IMREAD_COLOR): always (H, W, 3) uint8 RGB: alpha and tRNS
      dropped (not composited), gray repeated, 16-bit samples cut to their
      high byte (libpng's strip_16, not a rounding division by 257), and
      an eXIf chunk's orientation applied as cv2 applies it (before or
      after the image data).  "unchanged" applies none.

Both modes expand gray at 1, 2 and 4 bits to 8 by scaling (x 255, 85 and
17: a 4-bit 1 reads as 17).  A file that is no PNG, is cut short, has a bad
CRC, an unknown chunk method, a colour type and depth the specification
does not pair, or a palette index past its PLTE raises ValueError naming
the file.

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

from deepim_tpu_torch.utils.jpeg import MODES, apply_orientation, tiff_orientation

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, the bit depths the specification allows)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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


def _samples(raw: np.ndarray, pos: int, width: int, height: int, channels: int, depth: int,
             name: str) -> tuple[np.ndarray, int]:
    """The (height, width, channels) samples of one image (or Adam7 pass)
    whose filtered rows start at raw[pos], as uint8 (depths up to 8, not
    yet scaled) or uint16; and the position after its rows."""
    stride = (width * channels * depth + 7) // 8
    n = height * (stride + 1)
    if raw.size < pos + n:
        raise ValueError(f"{name}: image data holds {raw.size} bytes, want {pos + n} or more")
    pix = np.ascontiguousarray(
        _unfilter(raw[pos:pos + n].reshape(height, stride + 1), height, stride, max(1, channels * depth // 8)))
    if depth == 16:
        vals = pix.view(">u2").astype(np.uint16)
    elif depth == 8:
        vals = pix
    else:
        bits = np.unpackbits(pix, axis=1).reshape(height, -1, depth)
        vals = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    return vals[:, :width * channels].reshape(height, width, channels), pos + n


def decode_png(data: bytes, name: str = "<bytes>", mode: str = "unchanged") -> np.ndarray:
    """PNG bytes -> the array cv2.imread gives in `mode` ("unchanged" or
    "color"), colour channels in RGB(A) order (see the module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    header, idat, palette, trns, exif = None, [], None, None, None
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"eXIf" and exif is None:
            exif = body
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, compression, filt, interlace = header
    if color not in _TYPES or depth not in _TYPES[color][1]:
        raise ValueError(f"{name}: colour type {color} at bit depth {depth} is not a PNG format")
    if compression or filt or interlace > 1:
        raise ValueError(f"{name}: unknown compression, filter or interlace method")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    channels = _TYPES[color][0]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        img = _samples(raw, 0, width, height, channels, depth, name)[0]
    else:
        img = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw > 0 and ph > 0:
                img[y0::dy, x0::dx], pos = _samples(raw, pos, pw, ph, channels, depth, name)
    return _as_cv2(img, color, depth, palette, trns, exif, mode, name)


def _as_cv2(img: np.ndarray, color: int, depth: int, palette, trns, exif, mode: str, name: str) -> np.ndarray:
    """Decoded samples (H, W, channels) -> what cv2.imread returns in `mode`,
    in RGB(A) order (the module docstring's rules)."""
    full = np.uint16(65535) if depth == 16 else np.uint8(255)
    if color == 3:
        idx = img[..., 0]
        if int(idx.max()) >= len(palette):
            raise ValueError(f"{name}: palette index {int(idx.max())} past the {len(palette)} PLTE entries")
        out = palette[idx]
        if trns is not None and mode == "unchanged":
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
            out = np.concatenate([out, alpha[idx][..., None]], axis=2)
    elif color in (0, 4):
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        gray = np.repeat(img[..., :1], 3, axis=2)
        out = img[..., 0] if color == 0 else np.concatenate([gray, img[..., 1:]], axis=2)
        if mode == "color":
            out = gray
    elif color == 2 and trns is not None and mode == "unchanged":
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int64)
        alpha = np.where((img.astype(np.int64) == key).all(axis=2), 0, full).astype(img.dtype)
        out = np.concatenate([img, alpha[..., None]], axis=2)
    else:
        out = img
    if mode == "unchanged":
        return np.ascontiguousarray(out)
    out = out[..., :3]
    if out.dtype == np.uint16:
        out = (out >> 8).astype(np.uint8)
    orientation = tiff_orientation(exif) if exif is not None else 1
    return apply_orientation(np.ascontiguousarray(out), orientation)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file as stored (decode_png's "unchanged"): (H, W) uint8
    or uint16 for gray, (H, W, 3) RGB, (H, W, 4) RGBA."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


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
