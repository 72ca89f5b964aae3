"""Batched tile-based triangle rasterizer (PyTorch counterpart of
deepim_tpu/render/rasterizer.py).

Pipeline, all batched:
  1. corner projection (explicit elementwise sums);
  2. the shared (B*F, 32) face-record table of anchored screen-space planes
     (build_face_records; lane layout in raster_kernels / pallas_raster),
     or, for csr_kernel="planes64", the raw corner pack (build_raw_pack)
     from which the kernel derives the same planes;
  3. tile binning: dense per-tile face lists (bin_faces) or exact CSR
     segments of (tile, pack-unit) pairs over 16x8 fine tiles, each tile's
     units ascending, with the per-unit tile budget (csr_budget) and the
     dropped-pair count (csr_segments: on the card the binning kernels
     count, place and order the real pairs, raster_kernels.csr_bin; on the
     CPU bin_faces_csr sorts one key per budget slot);
  4. one count-sorted work list over all (sample, tile) pairs (a stable
     torch sort of the tiles' pair counts), keeping the `active_tiles`
     budget;
  5. the z-buffer + shade kernel (raster_kernels.csr_raster,
     csr_planes_raster or tile_raster: CUDA on the card, plain twins on
     CPU);
  6. untiling into (B, H, W).
rasterize_textured runs the same pipeline on texture coordinates in place
of colours and samples the texture once per pixel (texture_gather).

Camera convention: pixel (i, j) is image-plane point u = fx x/z + cx = j,
v = fy y/z + cy = i; depth is camera-frame z.  Faces with a corner outside
(znear, zfar) are culled, the depth test keeps the largest 1/z and exact
ties go to the earliest-drawn (lowest id) face.

Path selection differs from the JAX package on purpose: `binning` alone
selects the kernel (CSR when binning == "csr", or "auto" with more than
2048 padded faces; otherwise dense).  `use_pallas` is kept so configs copy
across and is ignored: the plain twins take the XLA fallback's place on the
CPU.  The JAX package's TPU machinery (group scan under lax.cond, 8-slot
merges, MXU prefix sums, one-hot histograms, inverse-permutation gathers)
is replaced by plain torch ops (sort, searchsorted, cumsum, indexing) and,
for the CSR binning on the card, by kernels of csrc/raster.cu.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.render.raster_kernels import (
    RAW_WIDTH,
    build_face_records,
    csr_bin,
    csr_planes_raster,
    csr_raster,
    tile_raster,
)
from deepim_tpu_torch.utils import tracing


@dataclass(frozen=True)
class RasterConfig:
    """Field-for-field copy of the JAX RasterConfig (see its comments for
    each knob's measured rationale on the TPU).  Fields that only shape the
    TPU kernels' schedule are kept so configs copy across:
    `chunk`/`vis_mem_budget` (XLA visibility loop), `use_pallas`,
    `csr_chunk` (only its divisibility by csr_pack matters: the CUDA kernels
    stage nothing), `worklist` (both orderings are the same stable sort
    here) and `csr_group`.  csr_kernel picks the CSR kernel:
    "slots8" (csr_raster, prebuilt face records) or "planes64"
    (csr_planes_raster, raw corner pack); any other value raises."""

    height: int = 480
    width: int = 640
    tile_h: int = 8
    tile_w: int = 128
    max_faces_per_tile: int = 512
    chunk: int = 32
    znear: float = 0.25
    zfar: float = 6.0
    active_tiles: int = 128
    bin_batch_chunk: int = 0
    backface_cull: int = 0
    raster_batch_chunk: int = 0
    vis_mem_budget: int = 2 << 30
    use_pallas: bool = False
    binning: str = "auto"
    bin_pairs: int = 0
    csr_tile_h: int = 16
    csr_tile_w: int = 8
    csr_chunk: int = 192
    csr_kernel: str = "slots8"
    worklist: str = "topk"
    csr_group: int = 1024
    csr_pack: int = 4
    csr_tiers: tuple = ()

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def num_tiles(self) -> int:
        return self.tiles_y * self.tiles_x


def uses_csr(cfg: RasterConfig, nfaces: int) -> bool:
    """The port's path rule: `binning` alone picks CSR vs dense."""
    return cfg.binning == "csr" or (cfg.binning == "auto" and nfaces > 2048)


def project_vertices(vertices: torch.Tensor, pose: torch.Tensor, k: torch.Tensor):
    """(B, V, 3) model-frame points -> (u, v, z), each (B, V).

    The rotation is applied as explicit elementwise sums (not einsum), so
    the float32 rounding does not depend on a matmul backend."""
    x, y, z = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    r, t = pose[..., :3], pose[..., 3]
    cam = [
        r[:, i, 0:1] * x + r[:, i, 1:2] * y + r[:, i, 2:3] * z + t[:, i:i + 1]
        for i in range(3)
    ]
    zc = cam[2]
    zs = torch.where(torch.abs(zc) < 1e-12, torch.full_like(zc, 1e-12), zc)
    u = (k[:, 0:1, 0] * cam[0] + k[:, 0:1, 1] * cam[1]) / zs + k[:, 0:1, 2]
    v = k[:, 1:2, 1] * cam[1] / zs + k[:, 1:2, 2]
    return u, v, zc


def _bbox_tiles(fu, fv, valid, th, tw, t_y, t_x, height, width):
    """Per-face screen bbox -> clamped tile bounds + on-screen validity."""
    umin, umax = fu.amin(-1), fu.amax(-1)
    vmin, vmax = fv.amin(-1), fv.amax(-1)
    bx0 = torch.clamp(torch.floor(umin / tw), 0, t_x - 1).long()
    bx1 = torch.clamp(torch.floor(umax / tw), 0, t_x - 1).long()
    by0 = torch.clamp(torch.floor(vmin / th), 0, t_y - 1).long()
    by1 = torch.clamp(torch.floor(vmax / th), 0, t_y - 1).long()
    offscreen = (umax < 0) | (umin > width - 1) | (vmax < 0) | (vmin > height - 1)
    return bx0, bx1, by0, by1, valid & ~offscreen


def bin_faces(fu, fv, valid, cfg: RasterConfig, th=None, tw=None):
    """Dense binning, batched: fu/fv (B, F, 3), valid (B, F) ->
    (tile_faces (B, T, K) int64 face ids in ascending order, -1 padded;
    counts (B, T) capped at max_faces_per_tile)."""
    th = cfg.tile_h if th is None else th
    tw = cfg.tile_w if tw is None else tw
    t_y, t_x = -(-cfg.height // th), -(-cfg.width // tw)
    k_cap = cfg.max_faces_per_tile
    f = fu.shape[1]
    dev = fu.device
    bx0, bx1, by0, by1, ok = _bbox_tiles(fu, fv, valid, th, tw, t_y, t_x, cfg.height, cfg.width)
    ty = torch.arange(t_y, device=dev).repeat_interleave(t_x)[None, :, None]
    tx = torch.arange(t_x, device=dev).repeat(t_y)[None, :, None]
    overlap = (
        ok[:, None, :]
        & (tx >= bx0[:, None, :]) & (tx <= bx1[:, None, :])
        & (ty >= by0[:, None, :]) & (ty <= by1[:, None, :])
    )  # (B, T, F)
    counts = torch.clamp(overlap.sum(-1), max=k_cap)
    face_ids = torch.arange(f, device=dev)
    keys = torch.where(overlap, face_ids, face_ids + f)
    keys = torch.sort(keys, dim=-1).values
    if f > k_cap:
        keys = keys[..., :k_cap]
    else:
        keys = torch.nn.functional.pad(keys, (0, k_cap - f), value=2 * f)
    return torch.where(keys < f, keys, torch.full_like(keys, -1)), counts


def _csr_pack_for(cfg: RasterConfig, f: int) -> int:
    """Effective binning pack: csr_pack reduced to the largest power of two
    dividing the padded face count (and csr_chunk)."""
    pack = max(1, cfg.csr_pack)
    while pack > 1 and (f % pack or cfg.csr_chunk % pack):
        pack //= 2
    return pack


def csr_budget(cfg: RasterConfig, n_units: int, n_tiles: int):
    """The CSR pair budget: ((end unit, S), ...), runs of units that keep
    at most S of their bbox tiles each (bin_pairs // units, 8 by default,
    or csr_tiers' runs), S at most n_tiles, the last run ending at
    n_units; and the capacity, the pairs a sample may keep (the sum of
    every unit's S)."""
    if cfg.csr_tiers:
        tiers = tuple((int(e), min(int(s), n_tiles)) for e, s in cfg.csr_tiers)
        if tiers[-1][0] != n_units:
            raise ValueError(
                f"csr_tiers cover {tiers[-1][0]} units but the mesh has {n_units} "
                "(padded faces / csr_pack changed since tune_raster_for_bank)"
            )
    else:
        s = min(max(cfg.bin_pairs // n_units, 1), n_tiles) if cfg.bin_pairs else min(8, n_tiles)
        tiers = ((n_units, s),)
    capacity = sum((end - (tiers[i - 1][0] if i else 0)) * s for i, (end, s) in enumerate(tiers))
    return tiers, capacity


def bin_faces_csr(fu, fv, valid, cfg: RasterConfig, th=None, tw=None):
    """Sparse binning, batched: (tile, unit) overlap pairs, a unit being
    csr_pack consecutive faces (union bbox of its valid faces).

    Each unit enumerates its bbox tiles in row-major order into a static
    budget of S slots (csr_budget); pairs past the budget are dropped and
    counted.  Returns (sorted_unit (B, N) int32, units ascending within
    each tile and U = invalid, N the budget's capacity; offsets (B, T)
    int64; counts (B, T) int64; dropped (B,) int64).  The plain version of
    raster_kernels.csr_bin, on any device."""
    th = cfg.tile_h if th is None else th
    tw = cfg.tile_w if tw is None else tw
    t_y, t_x = -(-cfg.height // th), -(-cfg.width // tw)
    n_tiles = t_y * t_x
    b, nfaces = fu.shape[0], fu.shape[1]
    dev = fu.device
    pack = _csr_pack_for(cfg, nfaces)
    bx0, bx1, by0, by1, ok = _bbox_tiles(fu, fv, valid, th, tw, t_y, t_x, cfg.height, cfg.width)
    if pack > 1:
        u = nfaces // pack
        okr = ok.reshape(b, u, pack)

        def unite(x, fill, reduce):
            return reduce(torch.where(okr, x.reshape(b, u, pack), torch.full_like(x.reshape(b, u, pack), fill)), -1)

        bx0 = unite(bx0, t_x - 1, torch.amin)
        bx1 = unite(bx1, 0, torch.amax)
        by0 = unite(by0, t_y - 1, torch.amin)
        by1 = unite(by1, 0, torch.amax)
        ok = okr.any(-1)
    f = nfaces // pack

    wbb = torch.clamp(bx1 - bx0 + 1, min=1)
    span = wbb * (by1 - by0 + 1)

    def tier_keys(u0, u1, s_t):
        slot = torch.arange(s_t, device=dev)[None, None, :]
        uidx = (u0 + torch.arange(u1 - u0, device=dev))[None, :, None]
        okm, spanm, wbbm = ok[:, u0:u1, None], span[:, u0:u1, None], wbb[:, u0:u1, None]
        pair_ok = okm & (slot < spanm)
        tile = (by0[:, u0:u1, None] + slot // wbbm) * t_x + bx0[:, u0:u1, None] + slot % wbbm
        tile = torch.clamp(tile, 0, n_tiles - 1)
        k = torch.where(pair_ok, tile * f + uidx, torch.full_like(tile, n_tiles * f))
        d = torch.where(okm[..., 0], torch.clamp(spanm[..., 0] - s_t, min=0), 0).sum(-1)
        return k.reshape(b, -1), d

    keys, drops = [], []
    u0 = 0
    for u1, s_t in csr_budget(cfg, f, n_tiles)[0]:
        k, d = tier_keys(u0, u1, s_t)
        keys.append(k)
        drops.append(d)
        u0 = u1
    key = torch.cat(keys, dim=1)
    dropped = torch.stack(drops).sum(0)
    key = torch.sort(key, dim=1).values  # keys are unique per sample
    sorted_unit = torch.where(key < n_tiles * f, key % f, torch.full_like(key, f)).int()
    # Tile t's pairs are the sorted keys in [t * f, (t + 1) * f): their
    # bounds by binary search (no histogram, whose output torch.bincount
    # would size from the data with a host sync, and no atomics).
    bounds = torch.arange(n_tiles + 1, device=dev) * f
    first = torch.searchsorted(key, bounds[None, :].expand(b, -1).contiguous())
    offsets = first[:, :n_tiles]
    counts = first[:, 1:] - offsets
    return sorted_unit, offsets, counts, dropped


def csr_segments(fu, fv, valid, cfg: RasterConfig, th: int, tw: int):
    """bin_faces_csr's outputs over th x tw tiles, from the binning kernels
    for CUDA tensors (raster_kernels.csr_bin, whose work follows the real
    pairs) and from bin_faces_csr for CPU tensors."""
    if fu.device.type != "cuda":
        return bin_faces_csr(fu, fv, valid, cfg, th, tw)
    nfaces = fu.shape[1]
    pack = _csr_pack_for(cfg, nfaces)
    t_y, t_x = -(-cfg.height // th), -(-cfg.width // tw)
    tiers, capacity = csr_budget(cfg, nfaces // pack, t_y * t_x)
    return csr_bin(fu.contiguous(), fv.contiguous(), valid.contiguous(), tiers, capacity, pack, th, tw,
                   cfg.height, cfg.width)


def build_raw_pack(fu, fv, fq, fcol, valid):
    """(N, 32) raw corner pack for csr_planes_raster (planes64), which
    derives the planes inside the kernel with build_face_records' formulas.
    A plain concatenation: [0:3] u, [3:6] v, [6:9] 1/z, [9:18] corner
    colors (corner-major), [18] global face id (float32, exact below
    2^24), [19] validity, [20:32] pad."""
    n = fu.shape[0]
    cols = torch.cat([
        fu, fv, fq, fcol.reshape(n, 9),
        torch.arange(n, dtype=fu.dtype, device=fu.device)[:, None],
        valid.to(fu.dtype)[:, None],
    ], dim=1)
    return torch.nn.functional.pad(cols, (0, RAW_WIDTH - cols.shape[1]))


def _face_validity(fu, fv, fz, face_valid, cfg: RasterConfig):
    """Render validity: in (znear, zfar), not a sliver, optional cull."""
    in_range = ((fz > cfg.znear) & (fz < cfg.zfar)).all(-1)
    screen_area = (
        (fu[..., 1] - fu[..., 0]) * (fv[..., 2] - fv[..., 0])
        - (fv[..., 1] - fv[..., 0]) * (fu[..., 2] - fu[..., 0])
    )
    valid = face_valid & in_range & (torch.abs(screen_area) > 1e-6)
    if cfg.backface_cull:
        valid = valid & (screen_area * cfg.backface_cull > 0)
    return valid


def _expand_k(k, b):
    return k.expand(b, 3, 3) if k.dim() == 2 else k


def gather_corners(attr, faces):
    """(B, V, 3) vertex attribute + (B, F, 3) faces -> (B, F, 3, 3)."""
    b, nf, _ = faces.shape
    idx = faces.reshape(b, nf * 3).long()[..., None].expand(b, nf * 3, 3)
    return torch.gather(attr, 1, idx).reshape(b, nf, 3, 3)


def expand_corners(vertices, colors, faces):
    """(B, V, 3) x2 + (B, F, 3) -> corners, corner_colors (B, F, 3, 3)."""
    return gather_corners(vertices, faces), gather_corners(colors, faces)


def csr_dropped_pairs(vertices, faces, face_valid, poses, k, cfg: RasterConfig,
                      device="cuda") -> torch.Tensor:
    """Face-tile pairs the CSR budget would drop for this batch at these
    poses (0 = exact render)."""
    dev = resolve_device(device)
    vertices, faces, face_valid, poses, k = (
        x.to(dev) for x in (vertices, faces, face_valid, poses, k)
    )
    b, nf = faces.shape[0], faces.shape[1]
    u, v, z = project_vertices(vertices, poses, _expand_k(k, b))
    idx = faces.reshape(b, nf * 3).long()
    fu, fv, fz = (torch.gather(a, 1, idx).reshape(b, nf, 3) for a in (u, v, z))
    valid = _face_validity(fu, fv, fz, face_valid, cfg)
    _, _, _, dropped = csr_segments(fu, fv, valid, cfg, th=cfg.csr_tile_h, tw=cfg.csr_tile_w)
    return dropped.sum()


def _sub_batches(vertices, colors, faces, face_valid, poses, k, cfg, corners, corner_colors, dev):
    """Move inputs to `dev`, expand corners and split the batch into
    raster_batch_chunk sub-batches of (faces, valid, poses, k, corners,
    corner_colors)."""
    faces, face_valid, poses, k = (x.to(dev) for x in (faces, face_valid, poses, k))
    b = faces.shape[0]
    kb = _expand_k(k, b)
    if corners is None or corner_colors is None:
        corners, corner_colors = expand_corners(vertices.to(dev), colors.to(dev), faces)
    else:
        corners, corner_colors = corners.to(dev), corner_colors.to(dev)
    c = cfg.raster_batch_chunk if cfg.raster_batch_chunk and b > cfg.raster_batch_chunk else b
    return [
        tuple(x[i:i + c] for x in (faces, face_valid, poses, kb, corners, corner_colors))
        for i in range(0, b, c)
    ]


def rasterize(vertices, colors, faces, face_valid, poses, k, cfg: RasterConfig = RasterConfig(),
              corners=None, corner_colors=None, with_stats: bool = False, device="cuda"):
    """Batched render.

    vertices/colors: (B, V, 3); faces: (B, F, 3); face_valid: (B, F);
    poses: (B, 3, 4); k: (3, 3) or (B, 3, 3); corners/corner_colors:
    optional pre-expanded (B, F, 3, 3) (MeshBuffers.expand_corners).
    Returns rgb (B, H, W, 3) in [0, 255] and depth (B, H, W); with
    `with_stats` also `dropped`, a 0-dim int64 tensor counting the CSR
    face-tile pairs the binning budget truncated (0 on the dense path)."""
    dev = resolve_device(device)
    outs = []
    for sub in _sub_batches(vertices, colors, faces, face_valid, poses, k, cfg,
                            corners, corner_colors, dev):
        with tracing.span("render.bin", dev):
            plan = _plan(*sub, cfg)
        with tracing.span("render.raster", dev):
            out = KERNELS[plan.kernel](*plan.args)
            outs.append(_untile(plan, out, cfg))
    rgb = torch.cat([o[0] for o in outs]) if len(outs) > 1 else outs[0][0]
    depth = torch.cat([o[1] for o in outs]) if len(outs) > 1 else outs[0][1]
    if not with_stats:
        return rgb, depth
    return rgb, depth, torch.stack([o[2] for o in outs]).sum()


def kernel_inputs(vertices, colors, faces, face_valid, poses, k, cfg: RasterConfig = RasterConfig(),
                  corners=None, corner_colors=None, device="cuda"):
    """The z-buffer kernel launches `rasterize` would make for this batch,
    as a list of (kernel name, wrapper arguments), one per sub-batch
    (`KERNELS[name](*args)` launches one)."""
    dev = resolve_device(device)
    plans = [_plan(*sub, cfg) for sub in _sub_batches(
        vertices, colors, faces, face_valid, poses, k, cfg, corners, corner_colors, dev)]
    return [(p.kernel, p.args) for p in plans]


KERNELS = {"csr_raster": csr_raster, "csr_planes_raster": csr_planes_raster, "tile_raster": tile_raster}
_CSR_KERNELS = {"slots8": "csr_raster", "planes64": "csr_planes_raster"}


@dataclass
class _Plan:
    """One sub-batch's kernel launch and what untiling its output needs."""

    kernel: str
    args: tuple
    b: int
    t_y: int
    t_x: int
    th: int
    tw: int
    flat_ids: torch.Tensor
    cnt_top: torch.Tensor
    dropped: torch.Tensor


def _plan(faces, face_valid, poses, kb, corners, corner_colors, cfg) -> _Plan:
    """Project, build face records, bin and build the work list."""
    b, nf, _ = faces.shape
    dev = faces.device
    # Global face ids ride the record table as float32 (exact below 2^24).
    if b * nf >= (1 << 24):
        raise ValueError(
            f"batch {b} x {nf} padded faces overflows the float32 face-id range "
            "(2^24); set RasterConfig.raster_batch_chunk to bound the per-call batch"
        )
    use_csr = uses_csr(cfg, nf)
    if use_csr:
        if cfg.csr_kernel not in _CSR_KERNELS:
            raise NotImplementedError(f"csr_kernel={cfg.csr_kernel!r} is no CSR kernel of the port's "
                                      f"(only {sorted(_CSR_KERNELS)})")
        th, tw = cfg.csr_tile_h, cfg.csr_tile_w
        if th * tw != 128:
            raise ValueError("csr tile must be 128 pixels")
    else:
        th, tw = cfg.tile_h, cfg.tile_w
    t_y, t_x = -(-cfg.height // th), -(-cfg.width // tw)
    t = t_y * t_x
    p = th * tw

    u, v, z = project_vertices(corners.reshape(b, nf * 3, 3), poses, kb)
    fu, fv, fz = u.reshape(b, nf, 3), v.reshape(b, nf, 3), z.reshape(b, nf, 3)
    valid = _face_validity(fu, fv, fz, face_valid, cfg)
    fq = 1.0 / torch.where(torch.abs(fz) < 1e-12, torch.full_like(fz, 1e-12), fz)
    planes64 = use_csr and cfg.csr_kernel == "planes64"
    records = (build_raw_pack if planes64 else build_face_records)(
        fu.reshape(b * nf, 3), fv.reshape(b * nf, 3), fq.reshape(b * nf, 3),
        corner_colors.reshape(b * nf, 3, 3), valid.reshape(b * nf),
    )

    if use_csr:
        sorted_unit, offsets, counts, dropped = csr_segments(fu, fv, valid, cfg, th=th, tw=tw)
        dropped_total = dropped.sum()
    else:
        bc = cfg.bin_batch_chunk if cfg.bin_batch_chunk and b > cfg.bin_batch_chunk else b
        parts = [bin_faces(fu[i:i + bc], fv[i:i + bc], valid[i:i + bc], cfg) for i in range(0, b, bc)]
        tile_faces = torch.cat([q[0] for q in parts])
        counts = torch.cat([q[1] for q in parts])
        dropped_total = torch.zeros((), dtype=torch.long, device=dev)

    # Count-sorted work list over all (sample, tile) pairs; a stable sort on
    # negated counts is lax.top_k's contract (ties by ascending flat id).
    a = min(-(-cfg.active_tiles * cfg.tile_h * cfg.tile_w // p), t) if cfg.active_tiles else t
    w_items = b * a
    neg_sorted, order = torch.sort(-counts.reshape(b * t), stable=True)
    cnt_top = (-neg_sorted[:w_items]).int().contiguous()
    flat_ids = order[:w_items]
    sample_of = flat_ids // t
    tile_of = flat_ids % t
    tile_xy = torch.stack([(tile_of % t_x) * tw, (tile_of // t_x) * th], dim=1).int().contiguous()

    if use_csr:
        pack = _csr_pack_for(cfg, nf)
        n_units = nf // pack
        n_pairs = sorted_unit.shape[1]
        seg_start = (sample_of * n_pairs + offsets.reshape(b * t)[flat_ids]).int().contiguous()
        unit_base = (sample_of * n_units).int().contiguous()
        kernel = _CSR_KERNELS[cfg.csr_kernel]
        args = (records, sorted_unit.reshape(-1).contiguous(), seg_start, cnt_top, tile_xy,
                unit_base, pack, tw)
    else:
        tf_sel = tile_faces.reshape(b * t, cfg.max_faces_per_tile)[flat_ids]
        tf_global = torch.where(tf_sel >= 0, tf_sel + (sample_of * nf)[:, None], -1).int()
        kernel = "tile_raster"
        args = (records, tf_global.contiguous(), cnt_top, tile_xy, th, tw)
    return _Plan(kernel, args, b, t_y, t_x, th, tw, flat_ids, cnt_top, dropped_total)


def _untile(plan: _Plan, out, cfg):
    """Kernel output -> rgb (b, H, W, 3), depth (b, H, W), dropped."""
    if plan.kernel in ("csr_raster", "csr_planes_raster"):
        q_t, rgbq_t = out[:, 0], out[:, 2:5]
    else:
        q_t, rgbq_t = out[:, 0], out[:, 1:4]
    hit = q_t > 0
    qsafe = torch.where(hit, q_t, torch.ones_like(q_t))
    depth_t = torch.where(hit, 1.0 / qsafe, torch.zeros_like(q_t))
    rgb_t = torch.where(hit[:, None], rgbq_t / qsafe[:, None], torch.zeros_like(rgbq_t))

    # Each (sample, tile) reads its work item's row, or the zero row when it
    # has none (un-selected or empty tiles).
    b, t_y, t_x, th, tw = plan.b, plan.t_y, plan.t_x, plan.th, plan.tw
    w_items = plan.cnt_top.shape[0]
    dev = out.device
    src = torch.full((b * t_y * t_x,), w_items, dtype=torch.long, device=dev)
    src[plan.flat_ids] = torch.where(plan.cnt_top > 0, torch.arange(w_items, device=dev), w_items)
    rgbd = torch.cat([rgb_t, depth_t[:, None]], dim=1).transpose(1, 2)  # (W, P, 4)
    rgbd = torch.cat([rgbd, rgbd.new_zeros((1, th * tw, 4))], dim=0)
    img = (
        rgbd[src]
        .reshape(b, t_y, t_x, th, tw, 4)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, t_y * th, t_x * tw, 4)
    )[:, : cfg.height, : cfg.width]
    return img[..., 0:3], img[..., 3], plan.dropped


def texture_gather(textures: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-pixel bilinear texture lookup (the reference fragment shader's
    texture2D).  textures: (B, TH, TW, 3); u, v: (B, H, W) texture
    coordinates, clamped to [0, 1], v up (v = 1 is row 0).  Returns
    (B, H, W, 3).  The four taps and weights are the JAX package's, in its
    order (F.grid_sample weighs them in another)."""
    b, th, tw, _ = textures.shape
    up = torch.clamp(u, 0.0, 1.0) * (tw - 1)
    vp = (1.0 - torch.clamp(v, 0.0, 1.0)) * (th - 1)
    x0 = torch.floor(up).int()
    y0 = torch.floor(vp).int()
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    fx = (up - x0)[..., None]
    fy = (vp - y0)[..., None]
    flat = textures.reshape(b, th * tw, 3)

    def pick(yy, xx):
        idx = (yy * tw + xx).reshape(b, -1, 1).long().expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(u.shape + (3,))

    return (
        pick(y0, x0) * (1 - fx) * (1 - fy)
        + pick(y0, x1) * fx * (1 - fy)
        + pick(y1, x0) * (1 - fx) * fy
        + pick(y1, x1) * fx * fy
    )


def rasterize_textured(vertices, uv, textures, faces, face_valid, poses, k,
                       cfg: RasterConfig = RasterConfig(), with_stats: bool = False, device="cuda"):
    """Batched render with per-fragment texture sampling: the same pipeline
    and kernels as `rasterize`, interpolating (u, v, 0) perspective-
    correctly in place of colours, then one texture_gather per pixel.

    vertices: (B, V, 3); uv: (B, V, 2); textures: (B, TH, TW, 3) in
    [0, 255]; faces/face_valid/poses/k as in `rasterize`.  Returns rgb
    (B, H, W, 3), 0 where nothing is hit, and depth (B, H, W)[, dropped]."""
    dev = resolve_device(device)
    uv = uv.to(dev)
    uvz = torch.cat([uv, torch.zeros_like(uv[..., :1])], dim=-1)
    uv_img, depth, dropped = rasterize(vertices, uvz, faces, face_valid, poses, k, cfg,
                                       with_stats=True, device=dev)
    rgb = texture_gather(textures.to(dev), uv_img[..., 0], uv_img[..., 1])
    rgb = torch.where((depth > 0)[..., None], rgb, torch.zeros_like(rgb))
    return (rgb, depth, dropped) if with_stats else (rgb, depth)


def rasterize_single(vertices, colors, faces, face_valid, pose, k, cfg: RasterConfig, device="cuda"):
    """Render one mesh at one pose: (V, 3), (V, 3), (F, 3), (F,), (3, 4),
    (3, 3) -> rgb (H, W, 3) in [0, 255], depth (H, W) (camera z, 0 where
    nothing is hit)."""
    rgb, depth = rasterize(vertices[None], colors[None], faces[None], face_valid[None], pose[None],
                           k, cfg, device=device)
    return rgb[0], depth[0]


def render_mask(depth: torch.Tensor, thresh: float = 0.2) -> torch.Tensor:
    """Object mask from rendered depth."""
    return (depth > thresh).to(depth.dtype)
