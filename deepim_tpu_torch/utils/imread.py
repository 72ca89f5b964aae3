"""imread: the port's counterpart of cv2.imread, for PNG and JPEG files.

    imread(path, "color")      # cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    imread(path, "unchanged")  # cv2.imread(path, cv2.IMREAD_UNCHANGED)

Like cv2, it picks the decoder by the file's first bytes, never by its
name: a JPEG saved as `-color.png` reads as a JPEG.  "color" gives (H, W,
3) uint8 RGB, the order every JAX site flips cv2's BGR into.  "unchanged"
gives cv2's array as it is, colour channels in cv2's B, G, R(, A) order,
since the JAX sites that read in this mode (depths, labels, masks) use it
unflipped.  What each mode returns for each kind of file is set out in
utils/png.py and utils/jpeg.py; the result equals cv2.imread's bit for bit
(tests/test_torch_imread.py).

Any other format (WEBP, TIFF, JPEG 2000, OpenEXR, BMP, ...) raises
ValueError naming the file and the format; so do the PNGs and JPEGs the
decoders do not read (arithmetic-coded, lossless or 12-bit JPEG).  A
missing file raises FileNotFoundError where cv2.imread returns None and
the JAX site asserts.
"""
from __future__ import annotations

import numpy as np

from deepim_tpu_torch.utils.jpeg import MODES, decode_jpeg
from deepim_tpu_torch.utils.png import decode_png

# (leading bytes, format) of the files cv2.imread recognises besides PNG
# and JPEG, to name them when refusing them.
_OTHER_FORMATS = (
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "BigTIFF"), (b"MM\x00+", "BigTIFF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000 codestream"),
    (b"\x76\x2f\x31\x01", "OpenEXR"), (b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
    (b"\xff\x0a", "JPEG XL"), (b"\x00\x00\x00\x0cJXL \r\n\x87\n", "JPEG XL"),
)


def image_format(data: bytes) -> str:
    """The format of an image file's bytes, by their signature: "PNG",
    "JPEG", another format's name, or "unknown"."""
    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"1234567fF" and data[2:3].isspace():
        return "PFM" if data[1:2] in b"fF" else "PNM"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


def imread(path: str, mode: str) -> np.ndarray:
    """Decode the PNG or JPEG file at `path` as cv2.imread does in `mode`
    ("color" or "unchanged"; see the module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    with open(path, "rb") as f:
        data = f.read()
    kind = image_format(data)
    if kind == "PNG":
        img = decode_png(data, path, mode)
    elif kind == "JPEG":
        img = decode_jpeg(data, path, mode)
    elif kind == "unknown":
        raise ValueError(f"{path}: not a PNG or JPEG file (first bytes {data[:12]!r}); imread reads those two")
    else:
        raise ValueError(f"{path}: a {kind} file; imread reads PNG and JPEG files only")
    if mode == "unchanged" and img.ndim == 3:
        img = np.ascontiguousarray(img[:, :, [2, 1, 0, 3][:img.shape[2]]])
    return img
