"""Hand-built work lists that renders never produce, for holding the
raster kernels to their plain twins where their face loops, culling and
z-buffers have their edges: stress_work_list for csr_raster and
csr_planes_raster, stress_tile_list (at the end) for tile_raster.

The CSR list.

Two samples of `n_faces` triangles each around one tile: mostly a few
pixels across, some covering the whole tile, a tenth invalid, some
degenerate (zero area, repeated corners), and the last quarter of every
sample exact copies of its first quarter (exact 1/z ties at a higher face
id: the smallest id must win).  The work items: every face of a sample in
one tile (several faces per thread of a block, and not a multiple of the
block), lists of exactly 128 faces and of one unit more, a sparse list, a
single unit, the copies with their originals, and empty items.  The segments lie apart in `sorted_unit`
with an out-of-range unit id between them, so a read past a segment shows.
"""
from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.render.raster_kernels import CSR_TILE_PIXELS, build_face_records
from deepim_tpu_torch.render.rasterizer import build_raw_pack


def _triangles(rng, n, x0, y0, tile_w, tile_h):
    """n faces' (fu, fv, fq, fcol, valid) as float32/bool numpy arrays."""
    cx = rng.uniform(x0 - 4, x0 + tile_w + 4, n)
    cy = rng.uniform(y0 - 4, y0 + tile_h + 4, n)
    kind = rng.rand(n)
    radius = np.where(kind < 0.7, rng.uniform(0.5, 3.0, n),
                      np.where(kind < 0.95, rng.uniform(3.0, 12.0, n), 40.0))
    ang = rng.uniform(0, 2 * np.pi, (n, 1)) + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.5, 0.5, (n, 3))
    fu = cx[:, None] + radius[:, None] * np.cos(ang)
    fv = cy[:, None] + radius[:, None] * np.sin(ang)
    flat = rng.rand(n) < 0.04
    fv[flat] = fv[flat, :1]           # zero area
    twin = rng.rand(n) < 0.03
    fu[twin, 1], fv[twin, 1] = fu[twin, 0], fv[twin, 0]  # a repeated corner
    fq = rng.uniform(0.8, 2.5, (n, 3))
    fcol = rng.uniform(0, 255, (n, 3, 3))
    valid = rng.rand(n) > 0.1
    q = n // 4
    for a in (fu, fv, fq, fcol, valid):
        a[n - q:] = a[:q]
    return (fu.astype(np.float32), fv.astype(np.float32), fq.astype(np.float32),
            fcol.astype(np.float32), valid)


def stress_work_list(pack: int, tile_w: int, n_faces: int = 1328, seed: int = 0, device="cpu"):
    """-> (records, raw, csr): the (2 * n_faces, 32) face-record table and
    raw corner pack of the same faces, and the arguments
    (sorted_unit, seg_start, seg_count, tile_xy, unit_base, pack, tile_w)
    that follow the table in csr_raster / csr_planes_raster.  n_faces (per
    sample) must be a multiple of 4 * pack."""
    if n_faces % (4 * pack) or CSR_TILE_PIXELS % tile_w:
        raise ValueError("n_faces must be a multiple of 4 * pack and tile_w must divide 128")
    rng = np.random.RandomState(seed)
    tile_h = CSR_TILE_PIXELS // tile_w
    x0, y0 = 5 * tile_w, 2 * tile_h
    parts = [_triangles(rng, n_faces, x0, y0, tile_w, tile_h) for _ in range(2)]
    fu, fv, fq, fcol, valid = (torch.from_numpy(np.concatenate(x)) for x in zip(*parts))
    records = build_face_records(fu, fv, fq, fcol, valid)
    raw = build_raw_pack(fu, fv, fq, fcol, valid)

    u = n_faces // pack                   # units per sample
    stage_u = CSR_TILE_PIXELS // pack     # units of 128 faces
    q_u = u // 4
    every = np.arange(u)
    items = [  # (sample, units ascending, tile origin)
        (0, every, (x0, y0)),
        (0, every[:0], (0, 0)),
        (1, every, (x0, y0)),
        (0, every[::3], (x0 + tile_w, y0)),
        (0, every[:stage_u], (x0, y0)),
        (0, every[:stage_u + 1], (x0, y0 + tile_h)),
        (1, every[:0], (x0, y0)),
        (1, every[:1], (x0, y0)),
        (0, np.concatenate([every[:q_u], every[u - q_u:]]), (x0, y0)),
    ]
    flat, seg_start = [], []
    for _, units, _ in items:
        seg_start.append(sum(len(x) for x in flat))
        flat += [units, np.array([2 * u])]  # the separator no segment covers
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int32))  # noqa: E731
    csr = (i32(np.concatenate(flat)), i32(seg_start), i32([len(x[1]) for x in items]),
           i32([x[2] for x in items]), i32([x[0] * u for x in items]))
    return records.to(device), raw.to(device), tuple(t.to(device) for t in csr) + (pack, tile_w)


def stress_tile_list(tile_h: int, tile_w: int, k_cap: int, seed: int = 0, device="cpu"):
    """-> tile_raster's arguments (records, tf_global, counts, tile_xy,
    tile_h, tile_w) for a dense work list of (W, k_cap) rows over
    n = k_cap rounded up to a multiple of 4 faces around one tile.

    Record row 0 is a guard that no list holds: it covers every tile,
    nearer than every face, so a kernel that reads a list past its count
    (where the rows hold -1, which the twin clamps to row 0) shows it on
    every pixel.  Rows 1..n are _triangles' faces (small, tile-filling,
    degenerate and invalid ones); the last quarter are copies of the first
    quarter in place and 1/z but not in colour, so which of two exactly
    tied faces won shows in the output.  The lists: every face in ascending,
    in descending (the copies come first and must win) and in shuffled
    order, a shuffled list on another tile, lists of 0 and 1 faces, of 128
    and 129 (a full chunk of the twin and one face more) and of 256 and 257
    (a full pass of the kernel and one face more; all four as far as k_cap
    allows), the copies before their originals, and an empty item last."""
    if k_cap < 8:
        raise ValueError("k_cap must be at least 8")
    rng = np.random.RandomState(seed)
    n = -(-k_cap // 4) * 4
    x0, y0 = 3 * tile_w, 2 * tile_h
    fu, fv, fq, fcol, valid = _triangles(rng, n, x0, y0, tile_w, tile_h)
    q = n // 4
    fcol[n - q:] = rng.uniform(0, 255, (q, 3, 3)).astype(np.float32)
    far = 16.0 * (tile_w + tile_h)
    guard = (np.array([[x0 - far, x0 + 2 * far, x0 - far]], np.float32),
             np.array([[y0 - far, y0 - far, y0 + 2 * far]], np.float32),
             np.full((1, 3), 3.0, np.float32), np.full((1, 3, 3), 255.0, np.float32), np.array([True]))
    fu, fv, fq, fcol, valid = (torch.from_numpy(np.concatenate([g, x]))
                               for g, x in zip(guard, (fu, fv, fq, fcol, valid)))
    records = build_face_records(fu, fv, fq, fcol, valid)

    every = 1 + np.arange(n)
    lists = [  # (face rows in draw order, tile origin)
        (every[:k_cap], (x0, y0)),
        (every[:0], (0, 0)),
        (every[::-1][:k_cap], (x0, y0)),
        (rng.permutation(every)[:k_cap], (x0, y0)),
        (rng.permutation(every)[:k_cap], (x0 + tile_w, y0)),
        (every[:1], (x0, y0)),
        (every[:128], (x0, y0)),
        (rng.permutation(every)[:129], (x0, y0 + tile_h)),
        (every[::-1][:256], (x0, y0)),
        (rng.permutation(every)[:257], (x0, y0)),
        (np.concatenate([every[n - q:], every[:q]])[:k_cap], (x0, y0)),
        (every[:0], (x0, y0)),
    ]
    tf_global = np.full((len(lists), k_cap), -1, np.int32)
    for row, (ids, _) in zip(tf_global, lists):
        row[:len(ids)] = ids
    args = (records, torch.from_numpy(tf_global), torch.tensor([len(x[0]) for x in lists], dtype=torch.int32),
            torch.tensor([x[1] for x in lists], dtype=torch.int32))
    return tuple(t.to(device) for t in args) + (tile_h, tile_w)
