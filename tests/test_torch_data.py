"""Parity of the port's data path (deepim_tpu_torch.utils.png, data/,
render/mesh.py loaders, tools/synth_data.py) with the JAX package's and
with cv2 on the CPU, on a 64x64 LINEMOD-layout devkit written by the JAX
package's generate_dataset.  Tolerances: PNG decode, pair records,
test samples and loader batches exact; resize_to against cv2.resize
to 1e-5 of the value range where the scale maps sizes exactly, 1e-4 where
the output size is rounded (the same bilinear rule in float32, cv2's
weights rounded otherwise); meshes to 1e-6; the port's generated devkit within 1 level
of colour and depth with equal hit masks (renders agree to rgb 5e-3 and
depth 1e-5 before the truncation to integers)."""
import os
import random
import shutil
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.data import loader as j_loader  # noqa: E402
from deepim_tpu.data import pairdb as j_pairdb  # noqa: E402
from deepim_tpu.data import preprocess as j_pre  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.synth_data import generate_dataset as j_generate  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.data import loader as t_loader  # noqa: E402
from deepim_tpu_torch.data import pairdb as t_pairdb  # noqa: E402
from deepim_tpu_torch.data import preprocess as t_pre  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
from deepim_tpu_torch.tools.synth_data import generate_dataset as t_generate  # noqa: E402
from deepim_tpu_torch.utils.imread import imread  # noqa: E402
from deepim_tpu_torch.utils.png import read_png, write_png  # noqa: E402
from test_torch_imread import png_bytes  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
RASTER = dict(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128, chunk=16, znear=0.05,
              zfar=10.0)
CLASSES = ("cube", "sphere")


def _meshes(mod):
    return {"cube": mod.make_test_cube(0.08), "sphere": mod.make_icosphere(0.05, 1)}


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("LM6d_refine_synth"))
    j_generate(path, _meshes(j_mesh), K64, n_train=3, n_val=5, height=H, width=W, z_range=(0.45, 0.6),
               raster_cfg=JRasterConfig(**RASTER))
    return path


def _cfg_dict(devkit_path, **test):
    return {
        "SCALES": [H, W],
        "output_path": os.path.join(devkit_path, "output"),
        "dataset": {
            "dataset": "LM6D_REFINE", "dataset_path": devkit_path, "root_path": devkit_path,
            "image_set": "train_", "test_image_set": "val_",
            "model_dir": os.path.join(devkit_path, "models"), "class_name": list(CLASSES),
            "INTRINSIC_MATRIX": K64.flatten().tolist(), "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True},
        "TEST": {"test_iter": 2, **test},
    }


def _cfgs(devkit_path, **test):
    d = _cfg_dict(devkit_path, **test)
    return j_update(JConfig(), d), update_config_dict(Config(), d)


def _assert_same(a, b, path="rec"):
    """Exact equality of nested records (numpy arrays by value and dtype)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


# -- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["observed/cube/000003-color.png", "observed/sphere/000004-label.png",
                                  "gt_observed/cube/000005-depth.png", "rendered/sphere/000006_0-depth.png"])
def test_read_png_equals_cv2_on_devkit_files(devkit, kind):
    """cv2-written 8-bit RGB, gray label and 16-bit depth files decode
    exactly as cv2.imread(IMREAD_UNCHANGED) does (RGB order)."""
    path = os.path.join(devkit, "data", kind)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[:, :, ::-1]
    got = read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert got.any()


def _test_images():
    rng = np.random.RandomState(3)
    rgb = (rng.rand(37, 29, 3) * 255).astype(np.uint8)
    rgb[5:20, 4:25] = (200, 17, 90)  # a flat region, where predictors differ from raw bytes
    return {
        "rgb": rgb,
        "rgba": (rng.rand(23, 31, 4) * 255).astype(np.uint8),
        "gray": (rng.rand(19, 40) * 255).astype(np.uint8),
        "depth16": (rng.rand(21, 33) * 65535).astype(np.uint16),
    }


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_filters_round_trip(tmp_path, filter_type):
    """Files encoded with each of the five row filters decode exactly, by
    read_png and by cv2."""
    for name, img in _test_images().items():
        path = str(tmp_path / f"{name}.png")
        write_png(path, img, filter_type=filter_type)
        np.testing.assert_array_equal(read_png(path), img, err_msg=name)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = ref[:, :, [2, 1, 0, 3][: ref.shape[2]]]
        np.testing.assert_array_equal(ref, img, err_msg=name)


def test_read_png_cv2_adaptive_filters(tmp_path):
    """A smooth image written by cv2 with libpng's adaptive filter choice
    (IMWRITE_PNG_ALL_FILTERS; cv2's own default writes Sub rows) uses
    Paeth or Average rows and decodes exactly."""
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([128 + 100 * np.sin(xx / 5.0) * np.cos(yy / 7.0), 128 + 80 * np.sin((xx + yy) / 9.0),
                    (xx * yy) % 256], axis=-1).astype(np.uint8)
    path = str(tmp_path / "smooth.png")
    cv2.imwrite(path, img[:, :, ::-1], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    raw = zlib.decompress(_chunk_data(path, b"IDAT"))
    filters = {raw[y * (64 * 3 + 1)] for y in range(48)}
    assert filters & {3, 4}, filters  # the byte-by-byte filters are exercised
    np.testing.assert_array_equal(read_png(path), img)


def _chunk_data(path, ctype):
    data = Path(path).read_bytes()
    pos, out = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == ctype:
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


def test_read_png_rejects_unsupported(tmp_path):
    """An Adam7-interlaced gray image and a 16-bit RGB one (both raised
    before every PNG type was read) decode exactly as cv2.imread reads
    them; a WEBP file cv2 writes, under a .png name, raises in read_png
    (no PNG) and in imread, which names its format."""
    gray = _test_images()["gray"]
    path = str(tmp_path / "a.png")
    Path(path).write_bytes(png_bytes(gray[:, :, None], 0, 8, interlace=True))
    assert Path(path).read_bytes()[28] == 1  # IHDR interlace byte: Adam7
    np.testing.assert_array_equal(read_png(path), gray)
    np.testing.assert_array_equal(read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    rgb16 = str(tmp_path / "rgb16.png")
    img16 = (np.random.RandomState(0).rand(8, 8, 3) * 65535).astype(np.uint16)
    cv2.imwrite(rgb16, img16)
    got = read_png(rgb16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img16[:, :, ::-1])
    np.testing.assert_array_equal(imread(rgb16, "color"), cv2.imread(rgb16, cv2.IMREAD_COLOR)[:, :, ::-1])
    webp = str(tmp_path / "w.png")
    Path(webp).write_bytes(cv2.imencode(".webp", _test_images()["rgb"])[1].tobytes())
    with pytest.raises(ValueError, match="not a PNG file"):
        read_png(webp)
    with pytest.raises(ValueError, match=r"w\.png: a WEBP file"):
        imread(webp, "color")


@pytest.mark.parametrize("target", [(48, 64), (96, 128), (40, 1000)])
def test_resize_to_matches_cv2(target):
    """resize_to (torch bilinear) against cv2.resize(INTER_LINEAR) on a
    colour image, a 0/1 mask and a depth map: same scale and shape, values
    to 1e-5 of each array's range (cv2 rounds its interpolation weights
    differently; 2.55e-3 on [0, 255] images)."""
    rng = np.random.RandomState(0)
    img = (rng.rand(64, 64, 3) * 255).astype(np.float32)
    mask = (rng.rand(64, 64) > 0.5).astype(np.float32)
    depth = (rng.rand(64, 64) * 2).astype(np.float32)
    for arr in (img, mask, depth):
        got, s = t_pre.resize_to(arr, *target)
        ref, s_ref = j_pre.resize_to(arr, *target)
        assert s == s_ref and got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, atol=1e-5 * float(arr.max()), rtol=0)
    same, s = t_pre.resize_to(img, 64, 64)
    assert s == 1.0 and same is img


@pytest.mark.parametrize("shape,target", [((481, 641), (480, 640)), ((240, 321), (479, 640)),
                                          ((100, 133), (480, 638))])
def test_resize_to_matches_cv2_rounded_sizes(shape, target):
    """resize_to where round(size * scale) is not size * scale: cv2 maps
    output pixel x to (x + 0.5) / scale - 0.5, not by the ratio of the two
    sizes.  A random image, a smooth one and a 0/1 ellipse mask within
    1e-4 of each one's range (measured: 4.8e-5, 1.4e-6 and 4.5e-5 at
    481x641), and the mask thresholded at 0.5 equal pixel for pixel."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = 127 + 100 * np.sin(xx / 17) * np.cos(yy / 23)
    arrays = {
        "random": (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.float32),
        "smooth": np.repeat(smooth[:, :, None], 3, axis=2).astype(np.float32),
        "mask": (((xx - w / 2) / (w / 3)) ** 2 + ((yy - h / 2) / (h / 3)) ** 2 < 1).astype(np.float32),
    }
    for name, arr in arrays.items():
        got, s = t_pre.resize_to(arr, *target)
        ref, s_ref = j_pre.resize_to(arr, *target)
        assert s == s_ref and got.shape == ref.shape and got.dtype == ref.dtype, name
        np.testing.assert_allclose(got, ref, atol=1e-4 * float(arr.max() - arr.min()), rtol=0, err_msg=name)
    np.testing.assert_array_equal(got >= 0.5, ref >= 0.5)


# -- pair records, samples, loader ---------------------------------------------

@pytest.mark.parametrize("image_set,flip", [("val_", False), ("train_", False), ("val_", True)])
def test_pairdb_records_equal(devkit, tmp_path, image_set, flip):
    """PairDB (classes, points, diameters) and load_gt_pairdb records
    equal the JAX package's exactly, flipped pairs included."""
    jc, tc = _cfgs(devkit)
    for cls in CLASSES:
        jdb = j_pairdb.PairDB("LM6D_REFINE", devkit, image_set + cls, cls, cache_dir=str(tmp_path / "j"))
        tdb = t_pairdb.PairDB("LM6D_REFINE", devkit, image_set + cls, cls, cache_dir=str(tmp_path / "t"))
        assert tdb.classes == jdb.classes and tdb.idx2class == jdb.idx2class
        assert tdb.class2idx(cls) == jdb.class2idx(cls) and tdb.diameter(cls) == jdb.diameter(cls)
        np.testing.assert_array_equal(tdb.points(cls), jdb.points(cls))
        _assert_same(jdb.gt_pairdb(), tdb.gt_pairdb())
        _, jrecs = j_pairdb.load_gt_pairdb(jc, "LM6D_REFINE", image_set + cls, cls, devkit, devkit, flip)
        _, trecs = t_pairdb.load_gt_pairdb(tc, "LM6D_REFINE", image_set + cls, cls, devkit, devkit, flip)
        assert len(trecs) == len(jrecs) == (2 if flip else 1) * (5 if image_set == "val_" else 3)
        for a, b in zip(jrecs, trecs):
            _assert_same(a, b)
    merged = t_pairdb.merge_pairdb([trecs, trecs])
    assert len(merged) == 2 * len(trecs)


def test_pose_file_round_trip(tmp_path):
    pose = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    t_pairdb.save_pose_file(str(tmp_path / "p.txt"), pose)
    np.testing.assert_array_equal(t_pairdb.load_pose_file(str(tmp_path / "p.txt")),
                                  j_pairdb.load_pose_file(str(tmp_path / "p.txt")))
    np.testing.assert_allclose(t_pairdb.load_pose_file(str(tmp_path / "p.txt")), pose, atol=1e-7)


@pytest.mark.parametrize("init_mask,dilate,flip", [
    ("box_rendered", False, False), ("box_rendered", True, False), ("box_gt_observed", False, False),
    ("mask_gt_observed", True, False), ("box_gt_observed", True, True), ("init", False, False),
])
def test_make_test_sample_equal(devkit, init_mask, dilate, flip):
    """make_test_sample equals the JAX package's exactly for each observed
    mask strategy, with and without MASK_DILATE (same random.Random)."""
    jc, tc = _cfgs(devkit, INIT_MASK=init_mask, MASK_DILATE=dilate)
    _, recs = j_pairdb.load_gt_pairdb(jc, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit, flip)
    for i, rec in enumerate(recs):
        a = j_pre.make_test_sample(rec, jc, random.Random(i))
        b = t_pre.make_test_sample(rec, tc, random.Random(i))
        _assert_same(a, b)
    if init_mask not in ("box_rendered", "init") or dilate:
        assert b["mask_observed"].sum() < b["mask_observed"].size  # a real mask, not the placeholder


def test_mask_helpers_equal():
    m = np.zeros((40, 50), np.float32)
    m[7:19, 11:33] = 1.0
    np.testing.assert_array_equal(t_pre.box_mask_from(m), j_pre.box_mask_from(m))
    np.testing.assert_array_equal(t_pre.box_mask_from(np.zeros_like(m)), np.zeros_like(m))
    assert t_pre.min_rect(m) == j_pre.min_rect(m)
    for seed in range(6):
        np.testing.assert_array_equal(t_pre.mask_dilate_np(m, random.Random(seed)),
                                      j_pre.mask_dilate_np(m, random.Random(seed)))


@pytest.mark.parametrize("batch_size,dilate", [(2, True), (4, False)])
def test_test_loader_batches_equal(devkit, batch_size, dilate):
    """TestLoader batches (the last padded with repeats) equal the JAX
    package's exactly, per-record dilation seeds included."""
    jc, tc = _cfgs(devkit, MASK_DILATE=dilate)
    _, recs = j_pairdb.load_gt_pairdb(jc, "LM6D_REFINE", "val_cube", "cube", devkit, devkit)
    jb = list(j_loader.TestLoader(recs, jc, batch_size).batches())
    tl = t_loader.TestLoader(recs, tc, batch_size)
    tb = list(tl.batches())
    assert len(tl) == len(tb) == len(jb) == -(-len(recs) // batch_size)
    for (a, va), (b, vb) in zip(jb, tb):
        assert va == vb
        _assert_same(a, b)
    assert tb[-1][1] == len(recs) - batch_size * (len(tb) - 1)


# -- meshes ---------------------------------------------------------------------

def _textured_model(path: Path):
    """An OBJ with texcoords (a seam: one position with two uvs) and a
    texture image written by cv2."""
    path.mkdir(parents=True, exist_ok=True)
    lines = ["v 0 0 0", "v 0.1 0 0", "v 0.1 0.1 0", "v 0 0.1 0.05",
             "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "vt 0.25 0.75",
             "f 1/1 2/2 3/3", "f 1/5 3/3 4/4", "f -4/1 -2/4 -1/4"]
    (path / "textured.obj").write_text("\n".join(lines) + "\n")
    yy, xx = np.mgrid[0:16, 0:24]
    tex = np.stack([xx * 10, yy * 15, (xx * yy) % 256], axis=-1).astype(np.uint8)
    cv2.imwrite(str(path / "texture_map.png"), tex[:, :, ::-1])


@pytest.mark.parametrize("kind", ["vertex_colour", "textured"])
def test_load_textured_mesh_equal(devkit, tmp_path, kind):
    """load_textured_mesh equals the JAX loader on the devkit's
    vertex-coloured OBJ and on an OBJ with a texture_map.png."""
    if kind == "textured":
        model_dir = tmp_path / "tex"
        _textured_model(model_dir)
    else:
        model_dir = Path(devkit) / "models" / "sphere"
    a = j_mesh.load_textured_mesh(str(model_dir))
    b = t_mesh.load_textured_mesh(str(model_dir))
    np.testing.assert_array_equal(b.faces, a.faces)
    np.testing.assert_allclose(b.vertices, a.vertices, atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.colors, a.colors, atol=1e-6, rtol=0)
    assert b.diameter() == pytest.approx(a.diameter(), abs=1e-7)
    if kind == "textured":
        assert b.num_vertices == 6  # 4 positions, two of them split at a seam
        kept, j_kept = (m.load_textured_mesh(str(model_dir), keep_texture=True) for m in (t_mesh, j_mesh))
        np.testing.assert_array_equal(kept.uv, j_kept.uv)
        np.testing.assert_array_equal(kept.texture, j_kept.texture)
        np.testing.assert_array_equal(kept.colors, b.colors)


def test_write_obj_round_trip(tmp_path):
    m = t_mesh.make_icosphere(0.05, 1)
    t_mesh.write_obj(str(tmp_path / "m.obj"), m)
    j_mesh.write_obj(str(tmp_path / "j.obj"), j_mesh.make_icosphere(0.05, 1))
    assert (tmp_path / "m.obj").read_text() == (tmp_path / "j.obj").read_text()


def test_generate_dataset_matches_jax(devkit, tmp_path):
    """The port's generate_dataset writes the same pose files, image lists
    and models as the JAX one, equal label images and hit masks, and colour
    and depth within 1 level; the JAX PairDB reads it unchanged."""
    out = str(tmp_path / "port_devkit")
    t_generate(out, _meshes(t_mesh), K64, n_train=3, n_val=5, height=H, width=W, z_range=(0.45, 0.6),
               raster_cfg=RasterConfig(**RASTER), device="cpu")
    n_png = 0
    for root, _, files in os.walk(devkit):
        if "cache" in root or "output" in root:
            continue
        for name in files:
            a_path = os.path.join(root, name)
            b_path = os.path.join(out, os.path.relpath(a_path, devkit))
            if not name.endswith(".png"):
                assert Path(b_path).read_text() == Path(a_path).read_text(), b_path
                continue
            a = cv2.imread(a_path, cv2.IMREAD_UNCHANGED).astype(np.int64)
            b = read_png(b_path).astype(np.int64)
            if a.ndim == 3:
                a = a[:, :, ::-1]
            if name.endswith("-label.png"):
                np.testing.assert_array_equal(b, a, err_msg=b_path)
            else:
                np.testing.assert_array_equal(b > 0, a > 0, err_msg=b_path)
                assert np.abs(b - a).max() <= 1, b_path
            n_png += 1
    assert n_png == 2 * 8 * 7
    _, recs = j_pairdb.load_gt_pairdb(JConfig(), "LM6D_REFINE", "val_cube", "cube", out, out)
    assert len(recs) == 5 and recs[0]["mask_idx"] == 1
    shutil.rmtree(out)


def _row_filters(path):
    """The filter byte of every row of a PNG."""
    width, height, depth, color = struct.unpack(">IIBB", _chunk_data(path, b"IHDR")[:10])
    stride = 1 + width * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = zlib.decompress(_chunk_data(path, b"IDAT"))
    return {raw[y * stride] for y in range(height)}


@pytest.mark.parametrize("kind", ["observed/cube/000000-color.png", "observed/sphere/000000-depth.png",
                                  "observed/sphere/000000-label.png", "rendered/cube/000000_0-color.png"])
def test_generate_dataset_filters_rows_as_cv2(devkit, tmp_path, kind):
    """The port's devkit PNGs carry the row filter that cv2.imwrite gives
    the JAX generator's (Sub, 1), so they decode as a JAX-written devkit's
    do."""
    out = str(tmp_path / "port_devkit")
    t_generate(out, _meshes(t_mesh), K64, n_train=0, n_val=1, height=H, width=W, z_range=(0.45, 0.6),
               raster_cfg=RasterConfig(**RASTER), device="cpu")
    jax_filters = _row_filters(os.path.join(devkit, "data", kind))
    assert jax_filters == {1}
    assert _row_filters(os.path.join(out, "data", kind)) == jax_filters


def test_load_image_rgb_gray_and_depth(tmp_path):
    """A gray colour file, a 16-bit depth, and the depth read as a colour
    image (cv2's IMREAD_COLOR keeps each sample's high byte; the port raised
    on it before it read as cv2 does): each equal to the JAX package's."""
    gray = (np.arange(48).reshape(6, 8) * 5).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(t_pre.load_image_rgb(str(tmp_path / "g.png")),
                                  j_pre.load_image_rgb(str(tmp_path / "g.png")))
    d = (np.arange(48).reshape(6, 8) * 1000).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), d)
    np.testing.assert_array_equal(t_pre.load_depth(str(tmp_path / "d.png"), 1000.0),
                                  j_pre.load_depth(str(tmp_path / "d.png"), 1000.0))
    np.testing.assert_array_equal(t_pre.load_image_rgb(str(tmp_path / "d.png")),
                                  j_pre.load_image_rgb(str(tmp_path / "d.png")))
