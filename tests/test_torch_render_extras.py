"""Parity of the port's rasterizer extras with the JAX package's on the
CPU: render/lighting.py, per-fragment texture sampling
(rasterizer.texture_gather, rasterize_textured), the texture-keeping mesh
loader and bank, load_ply and render/standalone.py.  The same numpy inputs
go through both packages.  Tolerances are stated in each test."""
import dataclasses
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.render import lighting as j_lighting  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render import rasterizer as j_raster  # noqa: E402
from deepim_tpu.render import standalone as j_standalone  # noqa: E402
from deepim_tpu_torch.render import lighting as t_lighting  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.render import rasterizer as t_raster  # noqa: E402
from deepim_tpu_torch.render import standalone as t_standalone  # noqa: E402
from deepim_tpu_torch.utils.png import write_png  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[250.0, 0.0, 32.0], [0.0, 250.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
RASTER = dict(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=256, chunk=16, znear=0.05,
              zfar=10.0)


def _poses(rng, b, z=0.5):
    rot = R.random(b, random_state=rng).as_matrix().astype(np.float32)
    t = np.stack([rng.uniform(-0.01, 0.01, b), rng.uniform(-0.01, 0.01, b), np.full(b, z)], 1)
    return np.concatenate([rot, t[:, :, None].astype(np.float32)], 2)


def checker_texture(size: int = 256, cells: int = 32) -> np.ndarray:
    """A checkerboard of yellow and blue squares (tests/test_texture_fidelity.py's)."""
    ij = np.indices((size, size)).sum(axis=0) // (size // cells)
    c = (ij % 2).astype(np.float32)
    return np.stack([c * 255, c * 255, (1 - c) * 255], axis=-1)


def _j_mesh(m):
    """The JAX package's Mesh holding the port mesh's arrays."""
    return j_mesh.Mesh(vertices=m.vertices, faces=m.faces, colors=m.colors, normals=m.normals, uv=m.uv,
                       texture=m.texture)


@pytest.mark.parametrize("kind", ["icosphere", "cube", "uv_sphere"])
def test_compute_vertex_normals_equal(kind):
    """Area-weighted vertex normals: atol 1e-6 (both float64 numpy, cast
    to float32)."""
    m = {"icosphere": t_mesh.make_icosphere(0.05, 2), "cube": t_mesh.make_test_cube(0.08),
         "uv_sphere": t_mesh.make_uv_sphere(0.05, 8, 16, t_mesh.smooth_texture(32))}[kind]
    got = t_lighting.compute_vertex_normals(m.vertices, m.faces)
    want = j_lighting.compute_vertex_normals(m.vertices, m.faces)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t_mesh.Mesh(m.vertices, m.faces, m.colors).vertex_normals(), got)


@pytest.mark.parametrize("per_sample", [False, True])
def test_lit_vertex_colors_equal(per_sample):
    """lit_vertex_colors with a (3,) light and a scalar ratio, and with
    (B, 3) lights and a (B,) ratio: atol 1e-3 on [0, 255] (the rotation is
    summed in another order)."""
    rng = np.random.RandomState(3)
    m = t_mesh.make_icosphere(0.05, 2)
    b = 3
    verts = np.repeat(m.vertices[None], b, 0)
    normals = np.repeat(t_lighting.compute_vertex_normals(m.vertices, m.faces)[None], b, 0)
    cols = rng.uniform(60, 255, verts.shape).astype(np.float32)
    pose = _poses(rng, b)
    if per_sample:
        lp = (rng.uniform(-0.5, 0.5, (b, 3)) + [0, 0, -0.5]).astype(np.float32)
        li = rng.uniform(0.8, 1.2, (b, 3)).astype(np.float32)
        ratio = np.asarray([0.4, 0.3, 0.2], np.float32)
    else:
        lp, li, ratio = np.float32([0.1, -0.2, -0.4]), np.float32([1.1, 0.9, 1.0]), 0.3
    want = np.asarray(j_lighting.lit_vertex_colors(*(jnp.asarray(x) for x in (verts, normals, cols, pose, lp, li)),
                                                   jnp.asarray(ratio) if per_sample else ratio))
    got = t_lighting.lit_vertex_colors(*(torch.from_numpy(x) for x in (verts, normals, cols, pose, lp, li)),
                                       torch.from_numpy(ratio) if per_sample else ratio)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    assert got.min() >= 0 and got.max() <= 255 and np.ptp(want) > 50


def test_texture_gather_equal():
    """texture_gather against JAX's on random uv (beyond [0, 1] too, to
    exercise the clamp), 2 textures: atol 1e-3."""
    rng = np.random.RandomState(0)
    tex = np.stack([t_mesh.smooth_texture(48, seed=1), checker_texture(48, 8)])
    uv = rng.uniform(-0.1, 1.1, (2, 8, 16, 2)).astype(np.float32)
    got = t_raster.texture_gather(torch.from_numpy(tex), torch.from_numpy(uv[..., 0]), torch.from_numpy(uv[..., 1]))
    want = j_raster.texture_gather(jnp.asarray(tex), jnp.asarray(uv[..., 0]), jnp.asarray(uv[..., 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    host = t_mesh._sample_texture(tex[0], uv[0].reshape(-1, 2)).reshape(8, 16, 3)
    np.testing.assert_allclose(got[0].numpy(), host, atol=1e-3, rtol=0)


# Textured renders: a 1,024-face uv sphere (the dense path, tile_raster's
# twin) and a 2,304-face one (the CSR path: JAX's interpreted slots8 Pallas
# kernel, csr_raster's twin here), smooth and checker textures.
_TEX_SCENES = {"dense": (16, 32, {}), "csr": (24, 48, dict(binning="csr", bin_pairs=2304 // 4 * 16))}


def _textured(kind, texture):
    n_lat, n_lon, extra = _TEX_SCENES[kind]
    mesh = t_mesh.make_uv_sphere(0.05, n_lat, n_lon, texture)
    bank = t_mesh.MeshBank.from_meshes([mesh], pad_multiple=64, keep_textures=True)
    b = 2
    pose = _poses(np.random.RandomState(5), b)
    arrs = (np.repeat(bank.vertices, b, 0), np.repeat(bank.uv, b, 0), np.repeat(bank.textures, b, 0),
            np.repeat(bank.faces, b, 0), np.repeat(bank.face_valid, b, 0), pose)
    jcfg = j_raster.RasterConfig(**RASTER, **extra, use_pallas=kind == "csr")
    return arrs, jcfg, t_raster.RasterConfig(**RASTER, **extra)


def _checker_share(got, want, hit, tol):
    return float((np.abs(got - want).max(-1) > tol)[hit].mean())


@pytest.mark.parametrize("kind", list(_TEX_SCENES))
def test_rasterize_textured_equal(kind):
    """rasterize_textured against JAX's: hit masks exact, depth atol 1e-5;
    the interpolated uv before the gather held to the raster's rgb rule
    scaled to [0, 1] (5e-3 / 255; measured on the CPU: 4e-7); the gathered
    rgb atol 5e-3 levels on a smooth texture (measured: 1e-3).  On a
    32x32-cell checker a uv difference at a cell edge can flip a tap, so
    there the share of hit pixels off by more than 1 level is held
    instead: at most 1% (measured: 0, the largest difference 8e-3)."""
    (verts, uv, tex, faces, valid, pose), jcfg, tcfg = _textured(kind, t_mesh.smooth_texture(256))
    tk = torch.from_numpy(K64)
    uvz = np.concatenate([uv, np.zeros_like(uv[..., :1])], -1)
    j_uv, j_depth = (np.asarray(x) for x in j_raster.rasterize(
        *(jnp.asarray(x) for x in (verts, uvz, faces, valid, pose, K64)), jcfg))
    t_uv, t_depth = (x.numpy() for x in t_raster.rasterize(
        *(torch.from_numpy(x) for x in (verts, uvz, faces, valid, pose)), tk, tcfg, device="cpu"))
    hit = j_depth > 0
    assert hit.sum() > 1000
    np.testing.assert_array_equal(t_depth > 0, hit)
    np.testing.assert_allclose(t_depth, j_depth, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_uv, j_uv, atol=5e-3 / 255, rtol=0)

    j_rgb, j_d2 = (np.asarray(x) for x in j_raster.rasterize_textured(
        *(jnp.asarray(x) for x in (verts, uv, tex, faces, valid, pose, K64)), jcfg))
    t_rgb, t_d2, dropped = t_raster.rasterize_textured(
        *(torch.from_numpy(x) for x in (verts, uv, tex, faces, valid, pose)), tk, tcfg, with_stats=True,
        device="cpu")
    assert int(dropped) == 0
    np.testing.assert_array_equal(t_d2.numpy(), t_depth)
    np.testing.assert_array_equal(j_d2, j_depth)
    np.testing.assert_allclose(t_rgb.numpy(), j_rgb, atol=5e-3, rtol=0)
    assert (t_rgb.numpy()[~hit] == 0).all() and t_rgb.numpy()[hit].min() > 30

    checker = np.repeat(checker_texture(256)[None], 2, 0)
    j_rgb = np.asarray(j_raster.texture_gather(jnp.asarray(checker), jnp.asarray(j_uv[..., 0]),
                                               jnp.asarray(j_uv[..., 1])))
    t_rgb = t_raster.rasterize_textured(*(torch.from_numpy(x) for x in (verts, uv, checker, faces, valid, pose)),
                                        tk, tcfg, device="cpu")[0].numpy()
    assert _checker_share(t_rgb, j_rgb * hit[..., None], hit, 1.0) <= 0.01


def test_mesh_bank_keep_textures_equal():
    """MeshBank(keep_textures=True) on two meshes with textures of other
    sizes: the padded uv and textures equal JAX's exactly, and arrays()
    carries them."""
    a = t_mesh.make_uv_sphere(0.05, 6, 12, t_mesh.smooth_texture(48, seed=2)[:40])
    b = t_mesh.make_uv_sphere(0.04, 4, 8, checker_texture(64, 8)[:, :56])
    tb = t_mesh.MeshBank.from_meshes([a, b], pad_multiple=32, keep_textures=True)
    jb = j_mesh.MeshBank.from_meshes([_j_mesh(a), _j_mesh(b)], pad_multiple=32, keep_textures=True)
    assert tb.textures.shape == (2, 64, 56, 3)
    for key in ("vertices", "colors", "faces", "face_valid", "uv", "textures"):
        np.testing.assert_array_equal(getattr(tb, key), getattr(jb, key), err_msg=key)
    assert set(tb.arrays()) == {"vertices", "colors", "faces", "face_valid", "uv", "textures"}
    tb.with_normals([a, b])
    jb.with_normals([_j_mesh(a), _j_mesh(b)])
    np.testing.assert_allclose(tb.normals, jb.normals, atol=1e-6, rtol=0)
    assert "normals" in tb.arrays()
    with pytest.raises(ValueError, match="keep_textures"):
        t_mesh.MeshBank.from_meshes([t_mesh.make_test_cube()], keep_textures=True)


@pytest.mark.parametrize("alpha", [False, True])
def test_load_textured_mesh_keep_texture_equal(tmp_path, alpha):
    """load_textured_mesh(keep_texture=True) on a textured.obj with 'vt'
    lines and a texture_map.png written by the port (RGB, or RGBA whose
    alpha is dropped), read by JAX through cv2: vertices, faces, uv,
    texture and baked colours equal."""
    mesh = t_mesh.make_uv_sphere(0.05, 5, 10, t_mesh.smooth_texture(40, seed=3))
    t_mesh.write_textured_obj(str(tmp_path), mesh)
    if alpha:
        rgb = np.round(mesh.texture).astype(np.uint8)
        write_png(str(tmp_path / "texture_map.png"),
                         np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 128, np.uint8)], -1))
    got = t_mesh.load_textured_mesh(str(tmp_path), keep_texture=True)
    want = j_mesh.load_textured_mesh(str(tmp_path), keep_texture=True)
    for key in ("vertices", "faces", "uv", "texture", "colors"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    np.testing.assert_array_equal(got.texture, np.round(mesh.texture))
    plain = t_mesh.load_textured_mesh(str(tmp_path))
    assert plain.uv is None and plain.texture is None


def _write_ply(path, fmt):
    """A PLY with normals, colours, a triangle and a quad (millimetres)."""
    v = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 10, 0], [5, 5, 10]], np.float32)
    n = np.array([[0, 0, 1]] * 5, np.float32)
    c = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 99, 199], [200, 100, 50]], np.uint8)
    faces = [[0, 1, 4], [0, 1, 2, 3]]
    head = (f"ply\nformat {fmt} 1.0\ncomment test\nelement vertex {len(v)}\nproperty float x\nproperty float y\n"
            "property float z\nproperty float nx\nproperty float ny\nproperty float nz\nproperty uchar red\n"
            f"property uchar green\nproperty uchar blue\nelement face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        for p, q, col in zip(v, n, c):
            if fmt == "ascii":
                f.write((" ".join(f"{x:g}" for x in (*p, *q)) + " " + " ".join(str(int(x)) for x in col) + "\n")
                        .encode())
            else:
                f.write(struct.pack("<6f3B", *p, *q, *col))
        for face in faces:
            if fmt == "ascii":
                f.write((f"{len(face)} " + " ".join(map(str, face)) + "\n").encode())
            else:
                f.write(struct.pack(f"<B{len(face)}i", len(face), *face))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_load_ply_equal(tmp_path, fmt):
    """load_ply with scale 0.001 on an ASCII and a binary PLY (normals,
    colours, a quad fan-triangulated): equal to JAX's."""
    path = str(tmp_path / "m.ply")
    _write_ply(path, fmt)
    got, want = t_mesh.load_ply(path, scale=0.001), j_mesh.load_ply(path, scale=0.001)
    for key in ("vertices", "faces", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.faces.shape == (3, 3) and got.vertices.max() == pytest.approx(0.01)


# standalone.render cases: (mode, shading, textured, bg_color, surf_color).
_STANDALONE = [
    ("rgb+depth", "flat", False, None, None),
    ("rgb", "phong", False, None, None),
    ("depth", "flat", False, None, None),
    ("rgb+depth", "flat", True, (0.2, 0.4, 0.6, 1.0), None),
    ("rgb+depth", "phong", True, None, None),
    ("rgb+depth", "phong", False, (1.0, 1.0, 1.0, 0.0), (0.8, 0.5, 0.3)),
]


def _standalone_both(mesh, im_size, k, pose, **kw):
    got = t_standalone.render(mesh, im_size, k, pose[:, :3], pose[:, 3], device="cpu", **kw)
    want = j_standalone.render(_j_mesh(mesh), im_size, k, pose[:, :3], pose[:, 3], **kw)
    return got, want


def _assert_standalone(got, want, mode):
    """uint8 rgb within 1 level (a float a hair apart can truncate to the
    next integer), depth atol 1e-5 with equal hit masks."""
    pairs = {"rgb": [(got, want, None)], "depth": [(None, None, (got, want))],
             "rgb+depth": [(got[0], want[0], (got[1], want[1]))]}[mode]
    for rgb_t, rgb_j, depth in pairs:
        if rgb_t is not None:
            assert rgb_t.dtype == np.uint8 and rgb_t.shape == rgb_j.shape
            assert np.abs(rgb_t.astype(int) - rgb_j.astype(int)).max() <= 1
        if depth is not None:
            np.testing.assert_array_equal(depth[0] > 0, depth[1] > 0)
            np.testing.assert_allclose(depth[0], depth[1], atol=1e-5, rtol=0)
            assert (depth[0] > 0).sum() > 500


@pytest.mark.parametrize("mode,shading,textured,bg,surf", _STANDALONE)
def test_standalone_render_equal(mode, shading, textured, bg, surf):
    """standalone.render against JAX's, each mode and shading, with and
    without a texture ([0, 1] floats), a background and a surface colour,
    on a 512-face uv sphere at 64x64 (the dense path)."""
    tex = t_mesh.smooth_texture(64, seed=4)
    mesh = t_mesh.make_uv_sphere(0.05, 16, 16, tex)
    pose = _poses(np.random.RandomState(6), 1)[0]
    kw = dict(mode=mode, shading=shading, texture=tex / 255.0 if textured else None, surf_color=surf,
              clip_near=0.05)
    if bg is not None:
        kw["bg_color"] = bg
    got, want = _standalone_both(mesh, (W, H), K64, pose, **kw)
    _assert_standalone(got, want, mode)


def test_standalone_render_csr_non_multiple_size():
    """A 4,608-face textured uv sphere at 100x90 (tiles of 16 rows and 16
    columns, neither dividing evenly): the port takes the CSR kernel
    (csr_raster's twin here) with a budget sized for the pose, JAX its
    dense XLA path; flat and phong, with the texture."""
    tex = t_mesh.smooth_texture(128, seed=5)
    mesh = t_mesh.make_uv_sphere(0.05, 48, 48, tex)
    k = np.array([[200.0, 0.0, 50.0], [0.0, 200.0, 45.0], [0.0, 0.0, 1.0]], np.float32)
    pose = _poses(np.random.RandomState(7), 1)[0]
    cfg = t_raster.RasterConfig(height=90, width=100, tile_h=16, tile_w=16)
    assert t_raster.uses_csr(cfg, mesh.num_faces)
    for shading in ("flat", "phong"):
        got, want = _standalone_both(mesh, (100, 90), k, pose, shading=shading, texture=tex, clip_near=0.05)
        assert got[0].shape == (90, 100, 3)
        _assert_standalone(got, want, "rgb+depth")


def test_standalone_render_close_object_every_tile(record_property):
    """A 320-face icosphere filling most of a 192x160 frame (the dense
    path; 240 tiles of 8x16, more than 128 of them covered).  The port's
    render rasterizes every tile (raster_config: active_tiles 0) and
    equals JAX's rasterize_single run with the port's raster_config, by
    the standalone rule (rgb within 1 level, depth 1e-5, equal hit
    masks).  JAX's own render keeps its RasterConfig's 128 active tiles
    and leaves the rest of the object unrendered: its hit mask is smaller
    (the count it misses is recorded)."""
    mesh = t_mesh.make_icosphere(0.05, 2)
    im_size, k = (192, 160), np.array([[250.0, 0.0, 96.0], [0.0, 250.0, 80.0], [0.0, 0.0, 1.0]], np.float32)
    pose = _poses(np.random.RandomState(8), 1, z=0.16)[0]
    cfg = t_standalone.raster_config(mesh, im_size, k, pose, 0.05, 10.0)
    assert (cfg.tile_h, cfg.tile_w, cfg.active_tiles) == (8, 16, 0) and not t_raster.uses_csr(cfg, mesh.num_faces)
    got = t_standalone.render(mesh, im_size, k, pose[:, :3], pose[:, 3], clip_near=0.05, device="cpu")
    covered = np.unique(np.argwhere(got[1] > 0) // (cfg.tile_h, cfg.tile_w), axis=0)
    assert len(covered) > 128
    fields = {f.name for f in dataclasses.fields(j_raster.RasterConfig)}
    jcfg = j_raster.RasterConfig(**{key: v for key, v in dataclasses.asdict(cfg).items() if key in fields})
    rgb, depth = j_raster.rasterize_single(jnp.asarray(mesh.vertices), jnp.asarray(mesh.colors),
                                           jnp.asarray(mesh.faces), jnp.ones(mesh.num_faces, bool),
                                           jnp.asarray(pose), jnp.asarray(k), jcfg)
    _assert_standalone(got, (np.clip(np.asarray(rgb), 0, 255).astype(np.uint8), np.asarray(depth)), "rgb+depth")
    own = j_standalone.render(_j_mesh(mesh), im_size, k, pose[:, :3], pose[:, 3], clip_near=0.05)
    missed = int((got[1] > 0).sum() - (own[1] > 0).sum())
    record_property("jax_render_pixels_missed", missed)
    assert missed > 0 and not ((own[1] > 0) & ~(got[1] > 0)).any()
