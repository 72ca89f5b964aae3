"""Host-side meshes, their OBJ and PLY loaders and padded
class-indexable mesh banks (numpy copy of deepim_tpu/render/mesh.py).

A textured model (textured.obj + texture_map.png) is baked into vertex
colours at load time: vertices are split at uv seams and the texture is
sampled once per vertex.  With keep_texture the mesh also keeps its
seam-split uv and the texture image, which MeshBank(keep_textures=True)
packs for the per-fragment texture-sampling render
(rasterizer.rasterize_textured, dataset.TEXTURE_SAMPLING).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from deepim_tpu_torch.render.lighting import compute_vertex_normals
from deepim_tpu_torch.utils.native import parse_obj_native
from deepim_tpu_torch.utils.imread import imread
from deepim_tpu_torch.utils.png import write_png


@dataclass
class Mesh:
    """A single triangle mesh with per-vertex colors."""

    vertices: np.ndarray  # (V, 3) float32, model frame (meters)
    faces: np.ndarray     # (F, 3) int32
    colors: np.ndarray    # (V, 3) float32 in [0, 255] (RGB)
    normals: np.ndarray | None = None  # (V, 3) float32, computed on first use
    # Per-vertex texture coordinates and the texture image, for the
    # per-fragment texture-sampling render; None = vertex colours only.
    uv: np.ndarray | None = None       # (V, 2) float32 in [0, 1]
    texture: np.ndarray | None = None  # (TH, TW, 3) float32 RGB in [0, 255]

    def vertex_normals(self) -> np.ndarray:
        if self.normals is None:
            self.normals = compute_vertex_normals(self.vertices, self.faces)
        return self.normals

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
    polygons are fan-triangulated, negative indices count from the end.
    As in the JAX package, the native parser (utils/native.py) reads the
    file when its library loads; its texture index of a vertex without
    one is 0."""
    native = parse_obj_native(path)
    if native is not None:
        v, vt, fv, fvt, vc = native
        return v, vt, fv, np.maximum(fvt, 0), vc

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
    uncoloured OBJ (grey 128).  The texture is read as cv2.imread(IMREAD_COLOR)
    reads it (any PNG or JPEG, by content; RGB).  With `keep_texture`, a
    textured model also keeps its seam-split uv and the texture as float32
    RGB for rasterize_textured."""
    v, vt, fv, fvt, vc = parse_obj(os.path.join(model_dir, obj_name))
    tex_path = os.path.join(model_dir, tex_name)
    if vc.shape[0] == v.shape[0] and not os.path.exists(tex_path):
        scale = 255.0 if vc.max() <= 1.0 + 1e-6 else 1.0
        colors = (vc * scale).astype(np.float32)
    elif os.path.exists(tex_path):
        tex = imread(tex_path, "color")
        v, vert_uv, fv = split_uv_seams(v, vt, fv, fvt)
        colors = _sample_texture(tex, vert_uv).astype(np.float32)
        return Mesh(vertices=v, faces=fv, colors=colors,
                    uv=vert_uv if keep_texture else None,
                    texture=tex.astype(np.float32) if keep_texture else None)
    else:
        colors = np.full((v.shape[0], 3), 128.0, np.float32)
    return Mesh(vertices=v, faces=fv, colors=colors)


# PLY property types -> (struct format, bytes).
_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8), "float64": ("d", 8),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
    "short": ("h", 2), "ushort": ("H", 2), "uchar": ("B", 1), "uint8": ("B", 1),
    "char": ("b", 1), "int8": ("b", 1),
}


def load_ply(path: str, scale: float = 1.0) -> Mesh:
    """Read a PLY mesh (ascii or binary_little_endian), the BOP model
    format: vertex x, y, z with optional nx, ny, nz and red, green, blue,
    and polygon faces (fan-triangulated).  `scale` converts units (BOP
    models are in millimetres: 0.001 gives metres).  Vertices without
    colours are grey 128."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elems: list[tuple[str, int, list[tuple[str, str]]]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.decode("ascii", "ignore").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elems.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                ptype = f"list:{parts[2]}:{parts[3]}" if parts[1] == "list" else parts[1]
                elems[-1][2].append((parts[-1], ptype))
            elif line.startswith("end_header"):
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: PLY format {fmt!r} is not read (ascii or binary_little_endian)")

        verts, cols, norms, faces = [], [], [], []
        for name, count, props in elems:
            for _ in range(count):
                record: dict = {}
                if fmt == "ascii":
                    vals = f.readline().split()
                    vi = 0
                    for pname, ptype in props:
                        if ptype.startswith("list"):
                            n = int(vals[vi])
                            record[pname] = [float(x) for x in vals[vi + 1:vi + 1 + n]]
                            vi += 1 + n
                        else:
                            record[pname] = float(vals[vi])
                            vi += 1
                else:
                    for pname, ptype in props:
                        if ptype.startswith("list"):
                            _, cnt_t, val_t = ptype.split(":")
                            cf, cs = _PLY_TYPES[cnt_t]
                            n = struct.unpack("<" + cf, f.read(cs))[0]
                            vf, vs = _PLY_TYPES[val_t]
                            record[pname] = list(struct.unpack(f"<{n}{vf}", f.read(vs * n)))
                        else:
                            vf, vs = _PLY_TYPES[ptype]
                            record[pname] = struct.unpack("<" + vf, f.read(vs))[0]
                if name == "vertex":
                    verts.append([record["x"], record["y"], record["z"]])
                    if "red" in record:
                        cols.append([record["red"], record["green"], record["blue"]])
                    if "nx" in record:
                        norms.append([record["nx"], record["ny"], record["nz"]])
                elif name == "face":
                    idx = [int(i) for i in record.get("vertex_indices", record.get("vertex_index"))]
                    for i in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])

    v = np.asarray(verts, np.float32) * scale
    colors = (np.asarray(cols, np.float32) if len(cols) == len(verts)
              else np.full((len(verts), 3), 128.0, np.float32))
    normals = np.asarray(norms, np.float32) if len(norms) == len(verts) else None
    return Mesh(vertices=v, faces=np.asarray(faces, np.int32).reshape(-1, 3), colors=colors,
                normals=normals)


def write_obj(path: str, mesh: Mesh) -> None:
    """Write a vertex-coloured OBJ ('v x y z r g b', colours in [0, 1])."""
    with open(path, "w") as f:
        for p, c in zip(mesh.vertices, mesh.colors / 255.0):
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for tri in mesh.faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def write_textured_obj(model_dir: str, mesh: Mesh, obj_name: str = "textured.obj",
                       tex_name: str = "texture_map.png") -> None:
    """Write a mesh with uv and a texture as a LINEMOD-style model
    directory: `obj_name` ('v', 'vt' and 'f a/a b/b c/c' lines, one texture
    coordinate per vertex) and the texture, rounded to uint8, as
    `tex_name`."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, obj_name), "w") as f:
        for p in mesh.vertices:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for uv in mesh.uv:
            f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
        for tri in mesh.faces + 1:
            f.write(f"f {tri[0]}/{tri[0]} {tri[1]}/{tri[1]} {tri[2]}/{tri[2]}\n")
    write_png(os.path.join(model_dir, tex_name), np.clip(np.round(mesh.texture), 0, 255).astype(np.uint8))


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
    normals: np.ndarray | None = None   # (C, Vmax, 3), for the lit render
    uv: np.ndarray | None = None        # (C, Vmax, 2), for texture sampling
    textures: np.ndarray | None = None  # (C, TH, TW, 3) zero-padded texture images

    def with_normals(self, meshes: list[Mesh]) -> "MeshBank":
        """Fill `normals` from each mesh's vertex normals; returns self."""
        c, vmax, _ = self.vertices.shape
        normals = np.zeros((c, vmax, 3), np.float32)
        for i, m in enumerate(meshes):
            normals[i, : m.num_vertices] = m.vertex_normals()
        self.normals = normals
        return self

    @staticmethod
    def from_meshes(meshes: list[Mesh], pad_multiple: int = 256, keep_textures: bool = False) -> "MeshBank":
        """Pack `meshes`.  With `keep_textures` every mesh must carry uv and
        a texture: the textures are zero-padded to the largest (TH, TW) and
        each mesh's uv rescaled so [0, 1] spans its own texture inside that
        canvas (v up: v = 1 is row 0)."""
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
        bank = MeshBank(verts, cols, faces, valid, nv, nf)
        if keep_textures:
            if any(m.uv is None or m.texture is None for m in meshes):
                raise ValueError("keep_textures requires uv + texture on every mesh")
            th = max(m.texture.shape[0] for m in meshes)
            tw = max(m.texture.shape[1] for m in meshes)
            uv = np.zeros((c, vmax, 2), np.float32)
            tex = np.zeros((c, th, tw, 3), np.float32)
            for i, m in enumerate(meshes):
                mh, mw = m.texture.shape[:2]
                uv[i, : m.num_vertices, 0] = m.uv[:, 0] * ((mw - 1) / max(tw - 1, 1))
                uv[i, : m.num_vertices, 1] = 1.0 - (1.0 - m.uv[:, 1]) * ((mh - 1) / max(th - 1, 1))
                tex[i, :mh, :mw] = m.texture
            bank.uv = uv
            bank.textures = tex
        return bank

    def arrays(self) -> dict[str, np.ndarray]:
        """The per-class arrays MeshBuffers.gather consumes: vertices,
        colors, faces and face_valid, and normals, uv and textures when
        the bank has them."""
        out = {"vertices": self.vertices, "colors": self.colors, "faces": self.faces,
               "face_valid": self.face_valid}
        for key in ("normals", "uv", "textures"):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key)
        return out


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


def make_colored_mesh(vertices: np.ndarray, faces: np.ndarray, colors: np.ndarray | None = None) -> Mesh:
    """A mesh from arrays; colours default to a uniform grey of 180."""
    if colors is None:
        colors = np.full((vertices.shape[0], 3), 180.0, np.float32)
    return Mesh(
        vertices=np.asarray(vertices, np.float32),
        faces=np.asarray(faces, np.int32),
        colors=np.asarray(colors, np.float32),
    )


def make_bumpy_mesh(radius: float = 0.05, subdiv: int = 3, seed: int = 0, bump: float = 0.35) -> Mesh:
    """An asymmetric 'asteroid': an icosphere displaced radially by a
    smooth random field and coloured by another, both drawn from one
    RandomState(seed) (6 lobes a field: a direction randn(3), a frequency,
    a phase, an amplitude per channel).  The float32 directions meet
    float64 lobe directions in `v @ d` as in the JAX package, so the
    vertices and colours equal its bit for bit."""
    base = make_icosphere(radius, subdiv)
    rng = np.random.RandomState(seed)
    v = base.vertices / radius  # unit sphere directions

    def smooth_field(channels: int) -> np.ndarray:
        out = np.zeros((v.shape[0], channels), np.float32)
        for _ in range(6):
            d = rng.randn(3)
            d /= np.linalg.norm(d)
            freq = rng.uniform(1.0, 3.0)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 1.0, channels)
            out += np.cos(freq * np.pi * (v @ d) + phase)[:, None] * amp
        return out

    disp = smooth_field(1)[:, 0]
    disp = 1.0 + bump * (disp - disp.min()) / max(np.ptp(disp), 1e-6) - bump / 2
    verts = (v * disp[:, None] * radius).astype(np.float32)
    col = smooth_field(3)
    col = (col - col.min(0)) / np.maximum(np.ptp(col, axis=0), 1e-6)
    colors = (40.0 + 200.0 * col).astype(np.float32)
    return Mesh(vertices=verts, faces=base.faces.copy(), colors=colors)


def make_benchmark_classes(n: int = 13, subdiv: int = 3) -> dict:
    """The synthetic accuracy benchmark's classes obj00..obj{n-1}: bumpy
    meshes of radius 0.035 + 0.005 i m (diameters ~0.07-0.19 m, the span
    of LINEMOD's objects), seed 100 + i, bump 0.25 + 0.02 i."""
    return {f"obj{i:02d}": make_bumpy_mesh(0.035 + 0.005 * i, subdiv, seed=100 + i, bump=0.25 + 0.02 * i)
            for i in range(n)}


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
    return Mesh(vertices=mesh.vertices, faces=mesh.faces[order].copy(), colors=mesh.colors,
                normals=mesh.normals, uv=mesh.uv, texture=mesh.texture)


def make_mixed_detail_mesh(seed: int = 0, fine_subdiv: int = 5) -> Mesh:
    """Heavy-tailed triangle-size mesh (~20.9k faces): subdiv-5 (or
    `fine_subdiv`), -2 and -1 icosphere shells (~2 px, ~15-25 px and
    ~30-60 px faces at 0.6 m), ordered by size band."""
    rng = np.random.RandomState(seed)
    parts = [
        make_icosphere(0.045, fine_subdiv),
        make_icosphere(0.058, 2),
        make_icosphere(0.072, 1),
    ]
    parts[1].vertices = parts[1].vertices + np.float32([0.035, 0.012, 0.0])
    parts[2].vertices = parts[2].vertices + np.float32([-0.038, -0.015, 0.01])
    for m in parts:
        hue = rng.uniform(80, 220, 3).astype(np.float32)
        m.colors = np.clip(m.colors * 0.5 + hue, 0, 255).astype(np.float32)
    return order_faces_for_binning(merge_meshes(parts))


def smooth_texture(size: int = 256, seed: int = 0, cells: int = 16) -> np.ndarray:
    """A band-limited (photograph-like) (size, size, 3) float32 RGB
    texture in [40, 215]: a seeded cells x cells grid of uniform colours,
    upsampled bilinearly."""
    rng = np.random.RandomState(seed)
    coarse = rng.uniform(40, 215, (cells, cells, 3)).astype(np.float32)
    x = np.linspace(0.0, cells - 1, size)
    i0 = np.minimum(np.floor(x).astype(np.int64), cells - 2)
    f = (x - i0).astype(np.float32)
    rows = coarse[i0] * (1 - f)[:, None, None] + coarse[i0 + 1] * f[:, None, None]
    return (rows[:, i0] * (1 - f)[None, :, None] + rows[:, i0 + 1] * f[None, :, None]).astype(np.float32)


def make_uv_sphere(radius: float, n_lat: int, n_lon: int, texture: np.ndarray) -> Mesh:
    """Latitude/longitude sphere (2 n_lat n_lon faces) with per-vertex uv
    (a duplicated seam column, u = longitude, v = 1 at the north pole),
    the texture and its colours baked per vertex."""
    i, j = np.meshgrid(np.arange(n_lat + 1), np.arange(n_lon + 1), indexing="ij")
    theta, phi = np.pi * i / n_lat, 2 * np.pi * j / n_lon
    verts = np.stack([radius * np.sin(theta) * np.cos(phi), radius * np.sin(theta) * np.sin(phi),
                      radius * np.cos(theta)], axis=-1).reshape(-1, 3)
    uv = np.stack([j / n_lon, 1.0 - i / n_lat], axis=-1).reshape(-1, 2).astype(np.float32)
    stride = n_lon + 1
    a = (np.arange(n_lat)[:, None] * stride + np.arange(n_lon)[None, :]).reshape(-1)
    faces = np.stack([np.stack([a, a + 1, a + stride], 1), np.stack([a + 1, a + stride + 1, a + stride], 1)],
                     axis=1).reshape(-1, 3)
    texture = np.asarray(texture, np.float32)
    return Mesh(vertices=verts.astype(np.float32), faces=faces.astype(np.int32),
                colors=_sample_texture(texture, uv).astype(np.float32), uv=uv, texture=texture)
