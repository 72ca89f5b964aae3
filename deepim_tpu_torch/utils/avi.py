"""A lossless video writer with no video package: RIFF AVI files whose
frames are PNG images (fourcc MPNG), which FFmpeg and the players built on
it decode.

The file is one RIFF 'AVI ' form: a 'hdrl' list (the main 'avih' header
and one video stream's 'strl': 'strh' with the frame rate as rate / scale
and 'strf', a BITMAPINFOHEADER naming MPNG), a 'movi' list of one '00dc'
chunk per frame, and an 'idx1' index of those chunks (each a key frame).
Frames are encoded with utils/png.py:encode_png and streamed to the file;
the sizes and the frame count are written into the headers at the end.
The RIFF form is limited to 4 GiB.
"""
from __future__ import annotations

import os
import struct
import time
from fractions import Fraction
from typing import Iterable

import numpy as np

from deepim_tpu_torch.utils.png import encode_png

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _avih(us_per_frame: int, n: int, max_bytes: int, width: int, height: int) -> bytes:
    return struct.pack("<4sI14I", b"avih", 56, us_per_frame, 0, 0, _AVIF_HASINDEX, n, 0, 1, max_bytes,
                       width, height, 0, 0, 0, 0)


def _strh(scale: int, rate: int, n: int, max_bytes: int, width: int, height: int) -> bytes:
    return struct.pack("<4sI4s4sIHHIIIIIIIIhhhh", b"strh", 56, b"vids", b"MPNG", 0, 0, 0, 0, scale, rate,
                       0, n, max_bytes, 0xFFFFFFFF, 0, 0, 0, width, height)


def _strf(width: int, height: int) -> bytes:
    return struct.pack("<4sIIiiHH4sIiiII", b"strf", 40, 40, width, height, 1, 24, b"MPNG",
                       width * height * 3, 0, 0, 0, 0)


def _headers(scale: int, rate: int, n: int, max_bytes: int, width: int, height: int) -> bytes:
    strl = b"strl" + _strh(scale, rate, n, max_bytes, width, height) + _strf(width, height)
    hdrl = (b"hdrl" + _avih(round(1e6 * scale / rate), n, max_bytes, width, height)
            + struct.pack("<4sI", b"LIST", len(strl)) + strl)
    return struct.pack("<4sI", b"LIST", len(hdrl)) + hdrl


def check_avi_path(path: str) -> str:
    """`path`, or ValueError when it does not end in .avi (so no AVI is
    written under another container's name)."""
    if os.path.splitext(path)[1].lower() != ".avi":
        raise ValueError(f"videos are written as AVI files, and {path!r} does not end in .avi")
    return path


def write_avi(path: str, frames_rgb_u8: Iterable[np.ndarray], fps: float) -> dict:
    """Write (H, W, 3) uint8 RGB frames, all of one size, to `path` (which
    must end in .avi) at `fps` frames a second.  Returns {'frames': n,
    'bytes': file size, 'encode_s': seconds spent encoding PNGs}."""
    check_avi_path(path)
    rate = Fraction(fps).limit_denominator(1001)
    if rate <= 0:
        raise ValueError(f"fps must be positive, got {fps}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    index, size, max_bytes, encode_s = [], None, 0, 0.0
    with open(path, "wb") as f:
        # Placeholders, rewritten once the frame count and sizes are known.
        f.write(struct.pack("<4sI4s", b"RIFF", 0, b"AVI ") + _headers(1, 1, 0, 0, 0, 0))
        movi_at = f.tell()
        f.write(struct.pack("<4sI4s", b"LIST", 0, b"movi"))
        for frame in frames_rgb_u8:
            frame = np.asarray(frame)
            if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
                raise ValueError(f"write_avi takes (H, W, 3) uint8 RGB frames, got {frame.dtype} {frame.shape}")
            if size is None:
                size = frame.shape[:2]
            elif frame.shape[:2] != size:
                raise ValueError(f"frame {len(index)} is {frame.shape[:2]}, the first one {size}")
            t0 = time.perf_counter()
            data = encode_png(frame)
            encode_s += time.perf_counter() - t0
            index.append((f.tell() - (movi_at + 8), len(data)))
            f.write(struct.pack("<4sI", b"00dc", len(data)) + data + b"\0" * (len(data) & 1))
            max_bytes = max(max_bytes, len(data))
        if size is None:
            raise ValueError("write_avi needs at least one frame")
        movi_end = f.tell()
        f.write(struct.pack("<4sI", b"idx1", 16 * len(index)))
        f.write(b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME, off, n) for off, n in index))
        end = f.tell()
        height, width = size
        f.seek(0)
        f.write(struct.pack("<4sI4s", b"RIFF", end - 8, b"AVI ")
                + _headers(rate.denominator, rate.numerator, len(index), max_bytes, width, height))
        f.seek(movi_at + 4)
        f.write(struct.pack("<I", movi_end - movi_at - 8))
    return {"frames": len(index), "bytes": end, "encode_s": encode_s}


def read_avi_index(path: str) -> dict:
    """The header of a file write_avi wrote, read back from its own
    structure: {'frames', 'width', 'height', 'fps', 'fourcc', 'chunks':
    [(offset in the file, length) of each frame's PNG]}.  Raises if the
    index, the headers and each frame's PNG header disagree."""
    with open(path, "rb") as f:
        data = f.read()
    riff, size, form = struct.unpack_from("<4sI4s", data, 0)
    if riff != b"RIFF" or form != b"AVI " or size != len(data) - 8:
        raise ValueError(f"{path}: not a complete RIFF AVI file")
    pos, found = 12, {}
    while pos + 8 <= len(data):
        fourcc, n = struct.unpack_from("<4sI", data, pos)
        if fourcc == b"LIST":
            found[data[pos + 8:pos + 12].decode()] = (pos + 12, n - 4)
        else:
            found[fourcc.decode()] = (pos + 8, n)
        pos += 8 + n + (n & 1)
    h_at = found["hdrl"][0]
    avih = struct.unpack_from("<14I", data, h_at + 8)
    strh_at = h_at + 8 + 56 + 12
    fcc_type, handler = struct.unpack_from("<4s4s", data, strh_at + 8)
    scale, rate, _, length = struct.unpack_from("<4I", data, strh_at + 8 + 20)
    movi_at, _ = found["movi"]
    idx_at, idx_n = found["idx1"]
    chunks = []
    for i in range(idx_n // 16):
        ckid, flags, off, n = struct.unpack_from("<4sIII", data, idx_at + 16 * i)
        at = movi_at - 4 + off
        if ckid != b"00dc" or data[at:at + 4] != b"00dc" or struct.unpack_from("<I", data, at + 4)[0] != n:
            raise ValueError(f"{path}: index entry {i} does not point at its frame")
        png_w, png_h = struct.unpack_from(">II", data, at + 8 + 16)
        if data[at + 8:at + 16] != b"\x89PNG\r\n\x1a\n" or (png_w, png_h) != (avih[8], avih[9]):
            raise ValueError(f"{path}: frame {i} is not a {avih[8]}x{avih[9]} PNG")
        chunks.append((at + 8, n))
    if not (avih[4] == length == len(chunks)) or fcc_type != b"vids":
        raise ValueError(f"{path}: frame counts disagree (avih {avih[4]}, strh {length}, index {len(chunks)})")
    return {"frames": len(chunks), "width": avih[8], "height": avih[9], "fps": rate / scale,
            "fourcc": handler.decode(), "chunks": chunks}
