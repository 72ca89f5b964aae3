"""Pure-numpy reader and writer of the MXNet NDArray-list ``.params``
format (counterpart of deepim_tpu/utils/mxnet_io.py, kept as the port's
own copy).

The reference ships and loads its checkpoints as ``prefix-%04d.params``
files written by ``mx.nd.save`` (reference: deepim/core/module.py:168-188,
lib/utils/load_model.py:10-67).  To import the pretrained FlowNet weights
and trained DeepIM checkpoints without an MXNet dependency, this module
implements the on-disk format directly:

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  num_arrays
    NDArray x num_arrays
    uint64  num_names
    (uint64 len + utf8 bytes) x num_names     names like "arg:conv2_weight"

NDArray (V2, mxnet >= 0.11):
    uint32  NDARRAY_V2_MAGIC = 0xF993FAC9
    int32   storage type (0 = dense; sparse not supported here)
    uint32  ndim, then ndim dims: uint32 in mxnet <= 1.3 (nnvm dim_t),
            int64 in mxnet >= 1.5; both are found in the wild, so the
            reader disambiguates by validating the bytes that follow
    int32   dev_type, int32 dev_id                (context; ignored on load)
    int32   type flag (0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64)
    raw     row-major data

V1 (0xF993FAC8) files use the same layout minus the storage-type field.
"""
from __future__ import annotations

import struct

import numpy as np

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

_DTYPES = {
    0: np.dtype("<f4"),
    1: np.dtype("<f8"),
    2: np.dtype("<f2"),
    3: np.dtype("<u1"),
    4: np.dtype("<i4"),
    5: np.dtype("<i1"),
    6: np.dtype("<i8"),
}
_DTYPE_FLAGS = {v: k for k, v in _DTYPES.items()}


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated .params file")
        self.pos += n
        return out


def _plausible_tail(cur: _Cursor, at: int) -> bool:
    """True if (dev_type:int32, dev_id:int32, dtype:int32) at `at` looks
    valid; used to disambiguate uint32 vs int64 shape dims."""
    if at + 12 > len(cur.buf):
        return False
    dev_type, dev_id, flag = struct.unpack_from("<iii", cur.buf, at)
    # kCPU=1, kGPU=2, kCPUPinned=3, kCPUShared=5.
    return 1 <= dev_type <= 8 and 0 <= dev_id < 1024 and flag in _DTYPES


def _read_shape(cur: _Cursor) -> tuple[int, ...]:
    ndim = cur.read("I")
    if ndim == 0:
        return ()
    if ndim > 32:
        raise ValueError(f"implausible ndim {ndim}")
    # Try int64 dims first (mxnet >= 1.5), validated by the context/dtype
    # fields that follow; fall back to uint32 dims (mxnet <= 1.3).
    for fmt, width in (("q", 8), ("i", 4)):
        end = cur.pos + width * ndim
        if end + 12 > len(cur.buf):
            continue
        dims = struct.unpack_from(f"<{ndim}{fmt}", cur.buf, cur.pos)
        if all(0 < d < 2**31 for d in dims) and _plausible_tail(cur, end):
            cur.pos = end
            return tuple(int(d) for d in dims)
    raise ValueError("could not parse NDArray shape (unknown dim width)")


def _read_ndarray(cur: _Cursor) -> np.ndarray:
    magic = cur.read("I")
    if magic == _V2_MAGIC:
        stype = cur.read("i")
        if stype != 0 and stype != 1:
            # kDefaultStorage enum value differs across versions (0 or 1);
            # anything else is row-sparse/CSR which we do not support.
            raise ValueError(f"unsupported storage type {stype}")
        shape = _read_shape(cur)
    elif magic == _V1_MAGIC:
        shape = _read_shape(cur)
    else:
        raise ValueError(f"unsupported NDArray magic 0x{magic:x}")
    if shape == ():
        return np.zeros((), np.float32)
    cur.read("ii")  # dev_type, dev_id
    flag = cur.read("i")
    dtype = _DTYPES[flag]
    n = int(np.prod(shape))
    data = np.frombuffer(cur.read_bytes(n * dtype.itemsize), dtype)
    return data.reshape(shape).copy()


def load_mxnet_params(path: str, strip_prefix: bool = True) -> dict[str, np.ndarray]:
    """Load an mx.nd.save dict file.  Names like ``arg:conv2_weight`` /
    ``aux:...`` have the prefix stripped when `strip_prefix` (matching
    lib/utils/load_model.py:29-37, which splits on ':')."""
    with open(path, "rb") as f:
        cur = _Cursor(f.read())
    magic = cur.read("Q")
    if magic != _LIST_MAGIC:
        raise ValueError(f"not an MXNet NDArray-list file (magic 0x{magic:x})")
    cur.read("Q")  # reserved
    n = cur.read("Q")
    arrays = [_read_ndarray(cur) for _ in range(n)]
    n_names = cur.read("Q")
    names = []
    for _ in range(n_names):
        ln = cur.read("Q")
        names.append(cur.read_bytes(ln).decode("utf-8"))
    if len(names) != len(arrays):
        raise ValueError("name/array count mismatch")
    out = {}
    for name, arr in zip(names, arrays):
        if strip_prefix and ":" in name:
            name = name.split(":", 1)[1]
        out[name] = arr
    return out


def save_mxnet_params(
    path: str,
    params: dict[str, np.ndarray],
    prefix: str = "arg",
    legacy_uint32_dims: bool = False,
) -> None:
    """Write an mx.nd.save-compatible dict file (V2 NDArrays).  `prefix`
    namespaces the names as MXNet checkpoints do ("arg:" / "aux:"); pass
    prefix="" for plain names.  `legacy_uint32_dims` writes mxnet<=1.3-style
    uint32 shape dims (the reader handles both)."""
    chunks = [struct.pack("<QQQ", _LIST_MAGIC, 0, len(params))]
    dim_fmt = "I" if legacy_uint32_dims else "q"
    for arr in params.values():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_FLAGS:
            arr = arr.astype(np.float32)
        chunks.append(struct.pack("<Ii", _V2_MAGIC, 0))
        chunks.append(struct.pack(f"<I{arr.ndim}{dim_fmt}", arr.ndim, *arr.shape))
        chunks.append(struct.pack("<iii", 1, 0, _DTYPE_FLAGS[arr.dtype]))
        chunks.append(arr.tobytes())
    chunks.append(struct.pack("<Q", len(params)))
    for name in params:
        full = f"{prefix}:{name}" if prefix else name
        raw = full.encode("utf-8")
        chunks.append(struct.pack("<Q", len(raw)) + raw)
    with open(path, "wb") as f:
        f.write(b"".join(chunks))
