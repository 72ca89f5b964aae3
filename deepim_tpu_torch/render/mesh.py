"""Host-side meshes, their OBJ loaders and padded class-indexable mesh
banks (numpy copy of the parts of deepim_tpu/render/mesh.py the
refinement and evaluation paths use).

A textured model (textured.obj + texture_map.png) is baked into vertex
colours at load time: vertices are split at uv seams and the texture is
sampled once per vertex.  Texture-carrying meshes (uv + texture image)
belong to the per-fragment texture-sampling render path, which this port
does not have yet (ROADMAP A8), so Mesh holds vertex colours only.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from deepim_tpu_torch.utils.png import read_png


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

    def diameter(self) -> float:
        """The bounding box's diagonal (an upper bound of the largest
        pairwise vertex distance; datasets ship models_info.txt instead)."""
        lo = self.vertices.min(axis=0)
        hi = self.vertices.max(axis=0)
        return float(np.linalg.norm(hi - lo))


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ parser.

    Returns (vertices (V, 3), texcoords (T, 2), faces_v (F, 3), faces_vt
    (F, 3), vertex colours (V, 3) or (0, 3)).  Reads 'v' (with the
    'v x y z r g b' colour extension), 'vt' and 'f a/b/c' lines;
    polygons are fan-triangulated, negative indices count from the end."""
    verts: list[list[float]] = []
    vcols: list[list[float]] = []
    texs: list[list[float]] = []
    faces_v: list[list[int]] = []
    faces_vt: list[list[int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
                if len(p) >= 7:
                    vcols.append([float(p[4]), float(p[5]), float(p[6])])
            elif line.startswith("vt "):
                p = line.split()
                texs.append([float(p[1]), float(p[2])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    sub = tok.split("/")
                    idx.append((int(sub[0]), int(sub[1]) if len(sub) > 1 and sub[1] else 0))
                for i in range(1, len(idx) - 1):
                    tri = [idx[0], idx[i], idx[i + 1]]
                    faces_v.append([t[0] - 1 if t[0] > 0 else len(verts) + t[0] for t in tri])
                    faces_vt.append([t[1] - 1 if t[1] > 0 else len(texs) + t[1] for t in tri])
    v = np.asarray(verts, np.float32)
    vt = np.asarray(texs, np.float32) if texs else np.zeros((1, 2), np.float32)
    fv = np.asarray(faces_v, np.int32)
    fvt = np.asarray(faces_vt, np.int32)
    vc = np.asarray(vcols, np.float32) if len(vcols) == len(verts) else np.zeros((0, 3), np.float32)
    return v, vt, fv, fvt, vc


def _sample_texture(texture: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear texture lookup at uv in [0, 1]^2 (v up, OpenGL's
    convention: row 0 of the image is v = 1)."""
    th, tw = texture.shape[:2]
    u = np.clip(uv[:, 0], 0.0, 1.0) * (tw - 1)
    v = (1.0 - np.clip(uv[:, 1], 0.0, 1.0)) * (th - 1)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    x1 = np.minimum(x0 + 1, tw - 1)
    y1 = np.minimum(y0 + 1, th - 1)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]
    t = texture.astype(np.float32)
    return (
        t[y0, x0] * (1 - fx) * (1 - fy)
        + t[y0, x1] * fx * (1 - fy)
        + t[y1, x0] * (1 - fx) * fy
        + t[y1, x1] * fx * fy
    )


def split_uv_seams(v: np.ndarray, vt: np.ndarray, fv: np.ndarray, fvt: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One vertex per distinct (position, texcoord) pair, so every face
    corner carries its exact uv.  Returns (vertices (V', 3), uv (V', 2),
    faces (F, 3))."""
    key = fv.astype(np.int64) * (len(vt) + 1) + (fvt.astype(np.int64) + 1)
    uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
    new_faces = inv.reshape(fv.shape).astype(np.int32)
    vi = (uniq // (len(vt) + 1)).astype(np.int64)
    ti = (uniq % (len(vt) + 1)).astype(np.int64) - 1
    new_v = v[vi]
    new_uv = np.where((ti >= 0)[:, None], vt[np.maximum(ti, 0)], 0.0).astype(np.float32)
    return new_v, new_uv, new_faces


def load_textured_mesh(model_dir: str, obj_name: str = "textured.obj",
                       tex_name: str = "texture_map.png", keep_texture: bool = False) -> Mesh:
    """Load a LINEMOD-style model directory into a vertex-coloured Mesh:
    a vertex-coloured OBJ (colours in [0, 1] or [0, 255]), an OBJ with a
    texture image (baked per vertex after splitting uv seams), or an
    uncoloured OBJ (grey 128)."""
    if keep_texture:
        raise NotImplementedError("keep_texture (per-fragment texture sampling) is not ported "
                                  "yet (ROADMAP A8)")
    v, vt, fv, fvt, vc = parse_obj(os.path.join(model_dir, obj_name))
    tex_path = os.path.join(model_dir, tex_name)
    if vc.shape[0] == v.shape[0] and not os.path.exists(tex_path):
        scale = 255.0 if vc.max() <= 1.0 + 1e-6 else 1.0
        colors = (vc * scale).astype(np.float32)
    elif os.path.exists(tex_path):
        tex = read_png(tex_path)
        if tex.ndim == 2:
            tex = np.repeat(tex[:, :, None], 3, axis=2)
        v, vert_uv, fv = split_uv_seams(v, vt, fv, fvt)
        colors = _sample_texture(tex[:, :, :3], vert_uv).astype(np.float32)
    else:
        colors = np.full((v.shape[0], 3), 128.0, np.float32)
    return Mesh(vertices=v, faces=fv, colors=colors)


def write_obj(path: str, mesh: Mesh) -> None:
    """Write a vertex-coloured OBJ ('v x y z r g b', colours in [0, 1])."""
    with open(path, "w") as f:
        for p, c in zip(mesh.vertices, mesh.colors / 255.0):
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for tri in mesh.faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


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
