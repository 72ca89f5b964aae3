"""The rasterizer's per-tile z-buffer + shading kernels: CUDA wrappers,
their plain PyTorch twins, launch counters and the nvcc build.

Counterpart of deepim_tpu/render/pallas_raster.py.  Three kernels, all in
csrc/raster.cu (the source explains their design and what bounds them):

* csr_raster  replaces pallas_raster._csr_chunk_kernel ("slots8", launched
  by pallas_csr_group): one 16x8 fine tile per work item, walking the
  tile's CSR segment of csr_pack-face units.  Output (W, 5, 128) rows
  [q, fid, r*q, g*q, b*q]; a pixel no face covers keeps q = -1e30 and
  fid = 1e30.
* csr_planes_raster replaces pallas_raster._csr_planes_kernel ("planes64",
  pallas_csr_group(kernel="planes64")): csr_raster's contract, but it
  reads the raw corner pack (rasterizer.build_raw_pack) and derives each
  face's planes while staging it, with build_face_records' operations in
  the same order, so its output equals csr_raster's bit for bit.
* tile_raster replaces pallas_raster._tile_kernel (dense path, launched by
  pallas_visibility_shade): one tile_h x tile_w tile per work item, looping
  over the tile's counts[w] face ids in list order.  Output (W, 4, P) rows
  [zq, r*q, g*q, b*q].

All resolve visibility with the TPU kernels' rule: the largest clamped
interpolated 1/z wins, exact ties go to the first face of the list (the
earliest-drawn face, as GL does): the smallest global face id in a CSR
segment, whose ids ascend, and the first position in a dense list, whatever
the order of its ids.

What bounds the CSR kernels on an H100 is issue slots and latency,
not bytes or operations: a few hundred faces per non-empty tile, each
covering half a pixel of it on average.  So the kernels give every face a
thread, which culls its face against the tile's 8 blocks of 16 pixels
(cull_rectangles) with an exact test (edge_maxima_plain is its
plain version: an edge plane that is negative where it is largest over a
rectangle is negative on all of it), evaluates only the pixels of the
blocks that are left, and enters the covered ones into a shared-memory
z-buffer with an atomic max on (1/z, smallest face row first).  The dense
kernel culls in the same way over tiles of up to 1,024 pixels (up to 64
blocks), with the cull spread over the whole thread block; its faces cover
many pixels, so it then gives every pixel a thread that walks its block's
surviving faces in list order and keeps the winner in registers.

A wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain twin only for CPU tensors; there is no fallback from one to the
other.  Each wrapper counts its launches in `<wrapper>.launches`, and by
card index in `<wrapper>.launches_by_device`.  The
twins evaluate the same planes in the same order (((a*dx) + (b*dy)) + c,
each op rounded on its own) and vectorise over (work items x face chunk x
pixels): a first-max torch.argmax inside a chunk, then a strict `>` merge
across chunks: per pixel the largest clamped 1/z and, among equals, the
first face of the list (the smallest face row, since a list's rows
ascend), which is the winner the kernels' z-buffer keeps.  The twins cull
nothing: they are the specification the culling kernels are held to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

REC_WIDTH = 32
RAW_WIDTH = 32  # raw corner-pack row (csr_planes_raster); 20 lanes used
NEG = -1e30
BIG = 1e30
CSR_TILE_PIXELS = 128
# Faces per twin chunk.
CSR_STAGE = 192
TILE_STAGE = 128
# Elements per (work items, chunk, pixels) temporary of the twins.
_TWIN_BUDGET = 1 << 25

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "raster.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Filled by load_library(): seconds spent in nvcc (0.0 when the library was
# already built) and nvcc's -Xptxas -v register/shared-memory report.
BUILD_INFO: dict = {}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "deepim_tpu_torch: nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
        "raster kernels are built from csrc/raster.cu at first use"
    )


def build_library(extra_flags: tuple = (), source: Path = SOURCE):
    """Build csrc/raster.cu with nvcc into _build/ (keyed by a hash of the
    source and flags) unless it is there already, and load it with ctypes.
    Returns (library, nvcc seconds, nvcc log, path).  The package builds
    its own source with no extra flags; tools/raster_ablation.py passes
    -D flags, or another version of the source to compare with."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    key = hashlib.sha256(Path(source).read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"raster_{key}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"raster_{key}.{os.getpid()}.tmp.so"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.csr_raster_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp]
    lib.csr_raster_launch.restype = ci
    lib.csr_planes_raster_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp]
    lib.csr_planes_raster_launch.restype = ci
    lib.tile_raster_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.tile_raster_launch.restype = ci
    return lib, seconds, log, str(so)


def load_library():
    """The package's kernels: built on first use, then cached."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib, seconds, log, path = build_library()
            BUILD_INFO.update(seconds=seconds, log=log, path=path)
        return _lib


def reset_launch_counts() -> None:
    for wrapper in (csr_raster, csr_planes_raster, tile_raster):
        wrapper.launches = 0
        wrapper.launches_by_device = {}


def _count_launch(wrapper, dev: torch.device) -> None:
    wrapper.launches += 1
    wrapper.launches_by_device[dev.index] = wrapper.launches_by_device.get(dev.index, 0) + 1


def _check_cuda_args(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _launch_check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def build_face_records(fu, fv, fq, fcol, valid):
    """(N, 32) table of anchored screen-space planes.

    fu, fv, fq: (N, 3) screen corners and corner 1/z; fcol: (N, 3, 3) corner
    colors; valid: (N,).  Every plane is evaluated as a*dx + b*dy + c with
    dx = px - u0 (anchored at corner 0).  Lane layout:
    [0] u0 [1] v0 [2:5] A0 B0 ar [5:7] A1 B1 [7:9] A2 B2 [9:12] Qa Qb q0
    [12] qmin [13] qmax [14] fid [15] pad [16:25] r*q, g*q, b*q planes
    [25:32] pad; ar = -1e30 marks a face that covers nothing."""
    n = fu.shape[0]
    u0, u1, u2 = fu[:, 0], fu[:, 1], fu[:, 2]
    v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
    area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0)
    ok = valid & (torch.abs(area) > 1e-12)
    s = torch.where(ok, torch.sign(area), torch.zeros_like(area))
    ar = torch.where(ok, torch.abs(area), torch.full_like(area, NEG))
    inv = 1.0 / torch.where(ok, area, torch.ones_like(area))

    def attr_plane(val):
        d1 = val[:, 1] - val[:, 0]
        d2 = val[:, 2] - val[:, 0]
        a = (d1 * (v2 - v0) - d2 * (v1 - v0)) * inv
        bb = (d2 * (u1 - u0) - d1 * (u2 - u0)) * inv
        return [a, bb, val[:, 0]]

    zero = torch.zeros_like(u0)
    cols = [
        u0, v0,
        -(v2 - v1) * s, (u2 - u1) * s, ar,
        -(v0 - v2) * s, (u0 - u2) * s,
        -(v1 - v0) * s, (u1 - u0) * s,
        *attr_plane(fq),
        fq.amin(1), fq.amax(1),
        torch.arange(n, dtype=fu.dtype, device=fu.device),
        zero,
    ]
    for ch in range(3):
        cols += attr_plane(fcol[:, :, ch] * fq)
    cols += [zero] * (32 - len(cols))
    return torch.stack(cols, dim=1)


def _pixel_coords(tile_xy, p, tile_w):
    lin = torch.arange(p, device=tile_xy.device)
    px = (tile_xy[:, 0:1] + lin % tile_w).float()
    py = (tile_xy[:, 1:2] + lin // tile_w).float()
    return px, py


def _coverage(rec, px, py):
    """rec (W, C, 32), px/py (W, P) -> (inside (W, C, P), qi (W, C, P))."""
    dx = px[:, None, :] - rec[..., 0:1]
    dy = py[:, None, :] - rec[..., 1:2]
    e0 = rec[..., 2:3] * dx + rec[..., 3:4] * dy + rec[..., 4:5]
    e1 = rec[..., 5:6] * dx + rec[..., 6:7] * dy
    e2 = rec[..., 7:8] * dx + rec[..., 8:9] * dy
    inside = torch.minimum(e0, torch.minimum(e1, e2)) >= 0
    qi = torch.clamp(
        rec[..., 9:10] * dx + rec[..., 10:11] * dy + rec[..., 11:12],
        rec[..., 12:13], rec[..., 13:14],
    )
    return inside, qi


def cull_rectangles(tile_w: int, *, tile_h: int | None = None):
    """The rectangles the kernels cull a face against, as
    (x_lo, x_hi, y_lo, y_hi) pixel offsets from the origin of a tile_h x
    tile_w tile, bounds included: the tile's blocks of bw x bh = 16 pixels
    (bw divides tile_w and bh tile_h; 4 x 4 where both sides allow it) in
    row-major order of the block grid.  tile_h defaults to the CSR kernels'
    128 // tile_w (8 blocks); a dense tile holds a multiple of 32 pixels."""
    if tile_h is None:
        if tile_w <= 0 or CSR_TILE_PIXELS % tile_w:
            raise ValueError(f"tile_w {tile_w} must divide {CSR_TILE_PIXELS}")
        tile_h = CSR_TILE_PIXELS // tile_w
    if tile_w <= 0 or tile_h <= 0 or (tile_h * tile_w) % 32:
        raise ValueError(f"tile {tile_h} x {tile_w} must hold a multiple of 32 pixels")
    bh = 1
    while bh < 4 and tile_h % (2 * bh) == 0:
        bh *= 2
    bw = 16 // bh
    while tile_w % bw:
        bw //= 2
    bh = 16 // bw
    per_row = tile_w // bw
    rects = []
    for k in range(tile_h * tile_w // 16):
        bx, by = (k % per_row) * bw, (k // per_row) * bh
        rects.append((bx, bx + bw - 1, by, by + bh - 1))
    return rects


def edge_maxima_plain(records, x_lo, x_hi, y_lo, y_hi):
    """Plain version of the kernels' cull: each face's three
    edge planes at the pixel of the rectangle [x_lo, x_hi] x [y_lo, y_hi]
    where that plane is largest (the signs of its two coefficients pick
    the corner), with _coverage's operations in its order.

    records (..., 32); the bounds are pixel coordinates broadcastable to
    records[..., 0].  Returns (..., 3).  Every operation is rounded on its
    own and rounding is monotone, so a plane is nowhere on the rectangle
    above its value here: a face with any maximum < 0 covers no pixel of
    the rectangle."""
    u0, v0 = records[..., 0], records[..., 1]
    x_lo, x_hi, y_lo, y_hi = (torch.as_tensor(t, dtype=records.dtype, device=records.device)
                              for t in (x_lo, x_hi, y_lo, y_hi))

    def plane_max(ja, jb):
        a, b = records[..., ja], records[..., jb]
        dx = torch.where(a >= 0, x_hi, x_lo) - u0
        dy = torch.where(b >= 0, y_hi, y_lo) - v0
        return a * dx + b * dy

    return torch.stack([plane_max(2, 3) + records[..., 4], plane_max(5, 6), plane_max(7, 8)], dim=-1)


def _winner_planes(records, best_gf, px, py):
    """Per-pixel winner record -> (fid, r*q, g*q, b*q), each (W, P)."""
    rec = records[best_gf.clamp(min=0)]  # (W, P, 32)
    dx = px - rec[..., 0]
    dy = py - rec[..., 1]
    chans = [
        rec[..., 16 + 3 * c] * dx + rec[..., 17 + 3 * c] * dy + rec[..., 18 + 3 * c]
        for c in range(3)
    ]
    return rec[..., 14], chans


def _zbuffer_plain(records, face_ids, live, px, py, best):
    """Merge one chunk of candidate faces into the running winner.

    face_ids/live: (W, C) global face ids in draw order; best = (q, gf)."""
    rec = records[face_ids.clamp(min=0)]  # (W, C, 32)
    inside, qi = _coverage(rec, px, py)
    qi = torch.where(inside & live[..., None], qi, torch.full_like(qi, NEG))
    a_c = torch.argmax(qi, dim=1, keepdim=True)  # first max = lowest face id
    q_c = torch.gather(qi, 1, a_c)[:, 0]
    f_c = torch.gather(face_ids, 1, a_c[:, 0])
    upd = q_c > best[0]
    return torch.where(upd, q_c, best[0]), torch.where(upd, f_c, best[1])


def csr_raster_plain(records, sorted_unit, seg_start, seg_count, tile_xy, unit_base,
                     pack: int, tile_w: int):
    """Plain PyTorch twin of csr_raster (same arguments, same output)."""
    w_items = seg_count.shape[0]
    p = CSR_TILE_PIXELS
    dev = records.device
    out = torch.empty((w_items, 5, p), dtype=torch.float32, device=dev)
    ch_u = max(1, CSR_STAGE // pack)
    wb = max(1, _TWIN_BUDGET // (ch_u * pack * p))
    pos_u = torch.arange(ch_u, device=dev)
    in_unit = torch.arange(pack, device=dev)
    last = max(sorted_unit.numel() - 1, 0)
    for w0 in range(0, w_items, wb):
        sl = slice(w0, min(w0 + wb, w_items))
        cnt = seg_count[sl].long()
        start = seg_start[sl].long()
        base = unit_base[sl].long()
        px, py = _pixel_coords(tile_xy[sl], p, tile_w)
        n = cnt.shape[0]
        best = (
            torch.full((n, p), NEG, dtype=torch.float32, device=dev),
            torch.full((n, p), -1, dtype=torch.long, device=dev),
        )
        n_chunks = -(-int(cnt.max()) // ch_u) if n else 0
        for c in range(n_chunks):
            pos = c * ch_u + pos_u
            live_u = pos[None, :] < cnt[:, None]  # (n, ch_u)
            unit = sorted_unit[(start[:, None] + pos[None, :]).clamp(max=last)].long()
            unit = torch.where(live_u, unit, torch.zeros_like(unit))
            gf = ((base[:, None] + unit)[..., None] * pack + in_unit).reshape(n, ch_u * pack)
            live = live_u.repeat_interleave(pack, dim=1)
            best = _zbuffer_plain(records, gf, live, px, py, best)
        q, gf = best
        hit = q > NEG
        fid, chans = _winner_planes(records, gf, px, py)
        out[sl, 0] = q
        out[sl, 1] = torch.where(hit, fid, torch.full_like(fid, BIG))
        for c in range(3):
            out[sl, 2 + c] = torch.where(hit, chans[c], torch.zeros_like(chans[c]))
    return out


def csr_planes_raster_plain(raw, sorted_unit, seg_start, seg_count, tile_xy, unit_base,
                            pack: int, tile_w: int):
    """Plain PyTorch twin of csr_planes_raster: the raw pack's planes from
    build_face_records (face ids from lane 18), then csr_raster_plain."""
    n = raw.shape[0]
    records = build_face_records(raw[:, 0:3], raw[:, 3:6], raw[:, 6:9], raw[:, 9:18].reshape(n, 3, 3),
                                 raw[:, 19] > 0)
    records[:, 14] = raw[:, 18]
    return csr_raster_plain(records, sorted_unit, seg_start, seg_count, tile_xy, unit_base,
                            pack, tile_w)


def tile_raster_plain(records, tf_global, counts, tile_xy, tile_h: int, tile_w: int):
    """Plain PyTorch twin of tile_raster (same arguments, same output)."""
    w_items, k_cap = tf_global.shape
    p = tile_h * tile_w
    dev = records.device
    out = torch.empty((w_items, 4, p), dtype=torch.float32, device=dev)
    ch = min(TILE_STAGE, max(k_cap, 1))
    wb = max(1, _TWIN_BUDGET // (ch * p))
    pos_c = torch.arange(ch, device=dev)
    for w0 in range(0, w_items, wb):
        sl = slice(w0, min(w0 + wb, w_items))
        cnt = counts[sl].long()
        ids = tf_global[sl].long()
        px, py = _pixel_coords(tile_xy[sl], p, tile_w)
        n = cnt.shape[0]
        best = (
            torch.full((n, p), NEG, dtype=torch.float32, device=dev),
            torch.full((n, p), -1, dtype=torch.long, device=dev),
        )
        n_chunks = -(-int(cnt.max()) // ch) if n else 0
        for c in range(n_chunks):
            pos = c * ch + pos_c
            live = pos[None, :] < cnt[:, None]
            face = ids[:, pos.clamp(max=k_cap - 1)]
            face = torch.where(live, face, torch.zeros_like(face))
            best = _zbuffer_plain(records, face, live, px, py, best)
        q, gf = best
        hit = q > NEG
        _, chans = _winner_planes(records, gf, px, py)
        out[sl, 0] = q
        for c in range(3):
            out[sl, 1 + c] = torch.where(hit, chans[c], torch.zeros_like(chans[c]))
    return out


def _csr_call(wrapper, plain, table, sorted_unit, seg_start, seg_count, tile_xy, unit_base,
              pack: int, tile_w: int):
    """Shared body of the CSR wrappers: the plain twin for CPU tensors;
    for CUDA tensors, validate them, launch `wrapper`'s kernel and count
    the launch."""
    name = wrapper.__name__
    if tile_w <= 0 or CSR_TILE_PIXELS % tile_w:
        raise ValueError(f"{name}: tile_w {tile_w} must divide {CSR_TILE_PIXELS}")
    if pack <= 0:
        raise ValueError(f"{name}: pack {pack} must be positive")
    args = (table, sorted_unit, seg_start, seg_count, tile_xy, unit_base)
    dev = table.device
    if dev.type == "cpu":
        return plain(*args, pack, tile_w)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check_cuda_args(name, args, (torch.float32,) + (torch.int32,) * 5)
    w_items = seg_count.shape[0]
    if table.dim() != 2 or table.shape[-1] != REC_WIDTH or tile_xy.shape != (w_items, 2):
        raise ValueError(f"{name}: bad face table or tile_xy shape")
    if table.shape[0] * REC_WIDTH >= 2**31:
        raise ValueError(f"{name}: face table exceeds 32-bit indexing")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: face table must be 16-byte aligned")
    out = torch.empty((w_items, 5, CSR_TILE_PIXELS), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in args), out.data_ptr(),
            w_items, int(pack), int(tile_w), stream,
        )
    _launch_check(name, rc)
    _count_launch(wrapper, dev)
    return out


def csr_raster(records, sorted_unit, seg_start, seg_count, tile_xy, unit_base,
               pack: int, tile_w: int):
    """CSR z-buffer + shade over 16x8 fine tiles.

    records (N, 32) f32 face records; sorted_unit (S,) i32 flat CSR unit ids;
    seg_start/seg_count (W,) i32 each work item's first slot in sorted_unit
    and its unit count; tile_xy (W, 2) i32 tile pixel origin; unit_base (W,)
    i32 the work item's sample * units per sample (global face id =
    (unit_base + unit) * pack + j).  Returns (W, 5, 128) f32
    [q, fid, r*q, g*q, b*q]."""
    return _csr_call(csr_raster, csr_raster_plain, records, sorted_unit, seg_start, seg_count,
                     tile_xy, unit_base, pack, tile_w)


def csr_planes_raster(raw, sorted_unit, seg_start, seg_count, tile_xy, unit_base,
                      pack: int, tile_w: int):
    """csr_raster from the raw corner pack: raw (N, 32) f32 rows of
    rasterizer.build_raw_pack ([0:3] u, [3:6] v, [6:9] 1/z, [9:18] corner
    colors, [18] face id, [19] validity); the other arguments and the
    output are csr_raster's."""
    return _csr_call(csr_planes_raster, csr_planes_raster_plain, raw, sorted_unit, seg_start,
                     seg_count, tile_xy, unit_base, pack, tile_w)


def tile_raster(records, tf_global, counts, tile_xy, tile_h: int, tile_w: int):
    """Dense z-buffer + shade over tile_h x tile_w tiles.

    records (N, 32) f32; tf_global (W, K) i32 global face ids in draw order
    (-1 padded past counts[w]); counts (W,) i32; tile_xy (W, 2) i32.
    Returns (W, 4, tile_h * tile_w) f32 [zq, r*q, g*q, b*q]."""
    dev = records.device
    if dev.type == "cpu":
        return tile_raster_plain(records, tf_global, counts, tile_xy, tile_h, tile_w)
    if dev.type != "cuda":
        raise ValueError(f"tile_raster: unsupported device {dev}")
    p = tile_h * tile_w
    if p > 1024 or p % 32:
        raise ValueError(f"tile_raster: tile of {p} pixels must be a multiple of 32, <= 1024")
    args = (records, tf_global, counts, tile_xy)
    _check_cuda_args("tile_raster", args, (torch.float32,) + (torch.int32,) * 3)
    w_items, k_cap = tf_global.shape
    if records.shape[-1] != REC_WIDTH or tile_xy.shape != (w_items, 2):
        raise ValueError("tile_raster: bad record or tile_xy shape")
    if records.shape[0] * REC_WIDTH >= 2**31:
        raise ValueError("tile_raster: record table exceeds 32-bit indexing")
    if records.data_ptr() % 16:
        raise ValueError("tile_raster: record table must be 16-byte aligned")
    out = torch.empty((w_items, 4, p), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_raster_launch(
            *(t.data_ptr() for t in args), out.data_ptr(),
            w_items, int(k_cap), p, int(tile_w), stream,
        )
    _launch_check("tile_raster", rc)
    _count_launch(tile_raster, dev)
    return out


reset_launch_counts()
