"""Meshes the benchmark renders, made from a seed (the real LINEMOD models
are not in the repository).  Frozen copies of the port's generators
(render/mesh.py: make_icosphere, merge_meshes, order_faces_for_binning,
make_mixed_detail_mesh), so an edit to the program cannot change the
scenes it is measured on.

A configuration's `meshes` entry picks the kind:
  {"kind": "icosphere", "subdiv": 5, "diameter_mm": [102.099]}
  {"kind": "mixed", "fine_subdiv": [5, 4], "diameter_mm": [...]}
one mesh per class, each scaled to its class's diameter.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _unit_icosphere(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t], [0, -1, -t],
                      [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
                      [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
                      [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        mids: dict[tuple[int, int], int] = {}
        vl = verts.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                vl.append(((np.asarray(vl[a]) + np.asarray(vl[b])) / 2).tolist())
                mids[key] = len(vl) - 1
            return mids[key]

        new = []
        for a, b, c in faces.tolist():
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.asarray(vl), np.asarray(new, np.int64)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return verts, faces


def icosphere(radius: float, subdiv: int, center=(0.0, 0.0, 0.0)):
    """(vertices, faces, colours by vertex direction in [0, 255])."""
    v, f = _unit_icosphere(subdiv)
    return v * radius + np.asarray(center), f, (v * 0.5 + 0.5) * 255.0


def _merge(parts):
    verts, faces, cols, off = [], [], [], 0
    for v, f, c in parts:
        verts.append(v)
        faces.append(f + off)
        cols.append(c)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces), np.concatenate(cols)


def _order_for_binning(verts, faces):
    """Faces in descending factor-2 size bands, stable within a band."""
    c = verts[faces]
    d = np.maximum(np.linalg.norm(c[:, 0] - c[:, 1], axis=-1),
                   np.maximum(np.linalg.norm(c[:, 1] - c[:, 2], axis=-1), np.linalg.norm(c[:, 2] - c[:, 0], axis=-1)))
    band = np.ceil(np.log2(max(float(d.max()), 1e-12) / np.maximum(d, 1e-12))).astype(np.int64)
    return faces[np.argsort(band, kind="stable")]


def _ape_like(diameter: float, subdiv: int, rng):
    """An icosphere of the diameter, its colour-by-direction turned by a
    seeded rotation."""
    v, f, _ = icosphere(diameter / 2.0, subdiv)
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return v, f, ((v / (diameter / 2.0)) @ rot.T * 0.5 + 0.5) * 255.0


def _mixed(diameter: float, fine_subdiv: int, rng):
    """make_mixed_detail_mesh's three shells (fine, subdiv 2, subdiv 1),
    each tinted by a seeded hue, faces ordered by size band, scaled so the
    shells' bounding diameter is `diameter`."""
    shells = ((0.045, fine_subdiv, (0.0, 0.0, 0.0)), (0.058, 2, (0.035, 0.012, 0.0)),
              (0.072, 1, (-0.038, -0.015, 0.01)))
    span = max(np.linalg.norm(np.subtract(ci, cj)) + ri + rj for ri, _, ci in shells for rj, _, cj in shells)
    parts = []
    for r, s, c in shells:
        v, f, col = icosphere(r, s, c)
        parts.append((v, f, np.clip(col * 0.5 + rng.uniform(80, 220, 3), 0, 255)))
    v, f, col = _merge(parts)
    return v * (diameter / span), _order_for_binning(v, f), col


# Padding of the bank's per-class arrays, as MeshBank.from_meshes pads.
PAD_MULTIPLE = 256


def make_bank(spec: dict, seed: int):
    """One mesh per class -> the bank arrays (vertices (C, V, 3), colours
    (C, V, 3), faces (C, F, 3) int32, face_valid (C, F)) zero-padded to
    multiples of PAD_MULTIPLE, and each class's real vertex count."""
    rng = np.random.default_rng([seed, 1])
    meshes = []
    for i, d_mm in enumerate(spec["diameter_mm"]):
        d = d_mm / 1000.0
        if spec["kind"] == "icosphere":
            meshes.append(_ape_like(d, spec["subdiv"], rng))
        elif spec["kind"] == "mixed":
            subs = spec["fine_subdiv"]
            meshes.append(_mixed(d, subs[i % len(subs)], rng))
        else:
            raise ValueError(f"unknown mesh kind {spec['kind']!r}")

    def rnd(n):
        return -(-n // PAD_MULTIPLE) * PAD_MULTIPLE

    vmax, fmax = rnd(max(len(m[0]) for m in meshes)), rnd(max(len(m[1]) for m in meshes))
    c = len(meshes)
    verts = np.zeros((c, vmax, 3), np.float32)
    cols = np.zeros((c, vmax, 3), np.float32)
    faces = np.zeros((c, fmax, 3), np.int32)
    valid = np.zeros((c, fmax), bool)
    for i, (v, f, col) in enumerate(meshes):
        verts[i, :len(v)], cols[i, :len(v)] = v, col
        faces[i, :len(f)], valid[i, :len(f)] = f, True
    return (verts, cols, faces, valid), np.array([len(m[0]) for m in meshes])
