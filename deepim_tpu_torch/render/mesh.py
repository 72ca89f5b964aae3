"""Host-side meshes and padded class-indexable mesh banks (numpy copy of
the parts of deepim_tpu/render/mesh.py the refinement path uses).

Texture-carrying meshes (uv + texture image) belong to the texture-sampling
render path, which this port does not have yet, so Mesh holds vertex
colors only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """A single triangle mesh with per-vertex colors."""

    vertices: np.ndarray  # (V, 3) float32, model frame (meters)
    faces: np.ndarray     # (F, 3) int32
    colors: np.ndarray    # (V, 3) float32 in [0, 255] (RGB)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


@dataclass
class MeshBank:
    """All object classes packed into zero-padded arrays, gathered by class
    index at render time."""

    vertices: np.ndarray    # (C, Vmax, 3) float32
    colors: np.ndarray      # (C, Vmax, 3) float32
    faces: np.ndarray       # (C, Fmax, 3) int32, padded with 0
    face_valid: np.ndarray  # (C, Fmax) bool
    num_vertices: np.ndarray  # (C,) int32
    num_faces: np.ndarray     # (C,) int32

    @staticmethod
    def from_meshes(meshes: list[Mesh], pad_multiple: int = 256) -> "MeshBank":
        def rnd(n):
            return ((n + pad_multiple - 1) // pad_multiple) * pad_multiple

        vmax = rnd(max(m.num_vertices for m in meshes))
        fmax = rnd(max(m.num_faces for m in meshes))
        c = len(meshes)
        verts = np.zeros((c, vmax, 3), np.float32)
        cols = np.zeros((c, vmax, 3), np.float32)
        faces = np.zeros((c, fmax, 3), np.int32)
        valid = np.zeros((c, fmax), bool)
        nv = np.zeros(c, np.int32)
        nf = np.zeros(c, np.int32)
        for i, m in enumerate(meshes):
            verts[i, : m.num_vertices] = m.vertices
            cols[i, : m.num_vertices] = m.colors
            faces[i, : m.num_faces] = m.faces
            valid[i, : m.num_faces] = True
            nv[i] = m.num_vertices
            nf[i] = m.num_faces
        return MeshBank(verts, cols, faces, valid, nv, nf)

    def arrays(self) -> dict[str, np.ndarray]:
        """The four per-class arrays MeshBuffers.gather consumes."""
        return {
            "vertices": self.vertices, "colors": self.colors,
            "faces": self.faces, "face_valid": self.face_valid,
        }


def make_test_cube(size: float = 0.1) -> Mesh:
    """Axis-aligned cube with a distinct color per side."""
    s = size / 2
    corners = np.array(
        [[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
         [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]], np.float32
    )
    quads = [
        (0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1),
        (3, 2, 6, 7), (0, 3, 7, 4), (1, 5, 6, 2),
    ]
    face_colors = np.array(
        [[255, 0, 0], [0, 255, 0], [0, 0, 255],
         [255, 255, 0], [255, 0, 255], [0, 255, 255]], np.float32
    )
    verts, cols, faces = [], [], []
    for qi, q in enumerate(quads):
        base = len(verts)
        for ci in q:
            verts.append(corners[ci])
            cols.append(face_colors[qi])
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
    return Mesh(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        colors=np.asarray(cols, np.float32),
    )


def make_icosphere(radius: float = 0.05, subdiv: int = 2) -> Mesh:
    """Icosphere (20 * 4^subdiv faces), colored by vertex direction."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64
    )
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64
    )
    for _ in range(subdiv):
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = verts.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(verts_list[a]) + np.asarray(verts_list[b])) / 2
                verts_list.append(m.tolist())
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    colors = (verts / radius * 0.5 + 0.5) * 255.0
    return Mesh(
        vertices=verts.astype(np.float32),
        faces=faces.astype(np.int32),
        colors=colors.astype(np.float32),
    )


def merge_meshes(meshes: list[Mesh]) -> Mesh:
    """Concatenate meshes, part-major (face ids offset per part)."""
    verts, faces, cols = [], [], []
    off = 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        cols.append(m.colors)
        off += m.num_vertices
    return Mesh(
        vertices=np.concatenate(verts).astype(np.float32),
        faces=np.concatenate(faces).astype(np.int32),
        colors=np.concatenate(cols).astype(np.float32),
    )


def order_faces_for_binning(mesh: Mesh) -> Mesh:
    """Reorder faces into descending factor-2 size bands (stable within a
    band) so tune_raster_for_bank can give each run of similar-size faces
    its own CSR budget tier.  Coverage and depth are unchanged."""
    c = mesh.vertices[mesh.faces]  # (F, 3, 3)
    d = np.maximum(
        np.linalg.norm(c[:, 0] - c[:, 1], axis=-1),
        np.maximum(
            np.linalg.norm(c[:, 1] - c[:, 2], axis=-1),
            np.linalg.norm(c[:, 2] - c[:, 0], axis=-1),
        ),
    )
    d_max = max(float(d.max()), 1e-12)
    band = np.ceil(np.log2(d_max / np.maximum(d, 1e-12))).astype(np.int64)
    order = np.argsort(band, kind="stable")
    return Mesh(vertices=mesh.vertices, faces=mesh.faces[order].copy(), colors=mesh.colors)


def make_mixed_detail_mesh(seed: int = 0) -> Mesh:
    """Heavy-tailed triangle-size mesh (~20.9k faces): subdiv-5, -2 and -1
    icosphere shells (~2 px, ~15-25 px and ~30-60 px faces at 0.6 m),
    ordered by size band."""
    rng = np.random.RandomState(seed)
    parts = [
        make_icosphere(0.045, 5),
        make_icosphere(0.058, 2),
        make_icosphere(0.072, 1),
    ]
    parts[1].vertices = parts[1].vertices + np.float32([0.035, 0.012, 0.0])
    parts[2].vertices = parts[2].vertices + np.float32([-0.038, -0.015, 0.01])
    for m in parts:
        hue = rng.uniform(80, 220, 3).astype(np.float32)
        m.colors = np.clip(m.colors * 0.5 + hue, 0, 255).astype(np.float32)
    return order_faces_for_binning(merge_meshes(parts))
