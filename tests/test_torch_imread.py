"""utils/imread.py (with utils/png.py and utils/jpeg.py under it) against
cv2.imread on the CPU, and the port's image-reading sites against the JAX
package's, which read through cv2.imread.

Files are at most 64x48, made from a seed with numpy, and written by cv2,
by PIL, and by this file's own PNG writer (png_bytes: zlib and numpy, for
what neither library writes: Adam7, gray at 1, 2 and 4 bits, tRNS on any
type; its rows cycle through the five filters).  Tolerance: every decoded
array exactly equal to cv2.imread's in both modes (IMREAD_COLOR flipped to
RGB, IMREAD_UNCHANGED as it is); every site's output exactly equal to its
JAX site's, the VOC samples included."""
import io
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.toolkit.adapt_devkit as j_adapt  # noqa: E402
import deepim_tpu.toolkit.stats as j_stats  # noqa: E402
from deepim_tpu.data import preprocess as j_pre  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu_torch.data import preprocess as t_pre  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.toolkit import adapt_devkit as t_adapt  # noqa: E402
from deepim_tpu_torch.toolkit import stats as t_stats  # noqa: E402
from deepim_tpu_torch.utils.imread import image_format, imread  # noqa: E402
from deepim_tpu_torch.utils.jpeg import _Decoder  # noqa: E402

torch.set_num_threads(2)

H, W = 48, 64
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


# -- writers -------------------------------------------------------------------

def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(ctype + payload))


def _filter(rows: np.ndarray, bpp: int) -> bytes:
    """Filter each row with type (row index % 5), as the PNG specification
    defines the five filters."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ft = y % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out += bytes([ft]) + ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes of a PNG row at `depth`."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-flat.shape[1] // per)
    padded = np.zeros((h, n * per), np.int64)
    padded[:, :flat.shape[1]] = flat
    packed = np.zeros((h, n), np.int64)
    for i in range(per):
        packed = (packed << depth) | padded[:, i::per]
    return packed.astype(np.uint8)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, palette=None, trns: bytes | None = None,
              interlace: bool = False, exif: bytes | None = None) -> bytes:
    """A PNG of (h, w, channels) integer samples, Adam7-interlaced or not."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    body = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            body += _filter(_pack(sub, depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if exif is not None:
        out += _chunk(b"eXIf", exif)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")


def png_case(ctype: int, depth: int, trns: bool, interlace: bool, seed: int = 0, hw=(H, W)) -> bytes:
    """A seeded PNG of colour type `ctype` at `depth`; with `trns`, a tRNS
    chunk that some pixels match (gray, RGB) or a few palette alphas."""
    rng = np.random.RandomState(seed)
    h, w = hw
    top = (1 << depth) - 1
    palette, chunk = None, None
    if ctype == 3:
        n = min(1 << depth, 200)  # 8-bit palettes use fewer entries than indices allow
        palette = rng.randint(0, 256, (n, 3))
        samples = rng.randint(0, n, (h, w, 1))
        if trns:
            chunk = bytes(rng.randint(0, 256, max(1, n // 2)).astype(np.uint8))
    else:
        samples = rng.randint(0, top + 1, (h, w, CHANNELS[ctype]))
        if trns:
            key = samples[0, 0]
            samples[rng.rand(h, w) < 0.2] = key
            chunk = b"".join(struct.pack(">H", int(v)) for v in key)
    return png_bytes(samples, ctype, depth, palette, chunk, interlace)


def _gradient(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * xx / max(w - 1, 1), 255 * yy / max(h - 1, 1), 127 + 120 * np.sin(xx / 7 + yy / 11)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def cv2_jpeg(rgb: np.ndarray, *params) -> bytes:
    return cv2.imencode(".jpg", rgb[:, :, ::-1] if rgb.ndim == 3 else rgb, list(params))[1].tobytes()


def pil_jpeg(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_like_cv2(path) -> None:
    """imread equals cv2.imread bit for bit in both modes."""
    path = str(path)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("unchanged", cv2.IMREAD_UNCHANGED)):
        ref = cv2.imread(path, flag)
        if mode == "color":
            ref = ref[:, :, ::-1]
        got = imread(path, mode)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, mode, got.dtype, got.shape, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=f"{path} {mode}")


def _write(path: Path, data: bytes) -> Path:
    path.write_bytes(data)
    return path


# -- PNG -------------------------------------------------------------------------

PNG_CASES = ([(0, d, t, i) for d in (1, 2, 4, 8, 16) for t in (False, True) for i in (False, True)]
             + [(2, d, t, i) for d in (8, 16) for t in (False, True) for i in (False, True)]
             + [(3, d, t, i) for d in (1, 2, 4, 8) for t in (False, True) for i in (False, True)]
             + [(c, d, False, i) for c in (4, 6) for d in (8, 16) for i in (False, True)])


@pytest.mark.parametrize("ctype,depth,trns,interlace", PNG_CASES,
                         ids=[f"type{c}-{d}bit{'-trns' if t else ''}{'-adam7' if i else ''}"
                              for c, d, t, i in PNG_CASES])
def test_png_equals_cv2(tmp_path, ctype, depth, trns, interlace):
    """Every colour type at every bit depth the specification allows, plain
    and Adam7, with and without tRNS (types 0, 2 and 3: the alpha types
    may not carry one), at 48x64 and at 5x3 (Adam7 passes that are empty or
    one pixel wide)."""
    for hw in ((H, W), (5, 3)):
        assert_like_cv2(_write(tmp_path / "p.png", png_case(ctype, depth, trns, interlace, seed=depth, hw=hw)))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgb16", "rgba8", "rgba16"])
def test_png_cv2_written_equals_cv2(tmp_path, kind):
    """Files cv2.imwrite writes (its default Sub rows, and libpng's adaptive
    filters), Adam7-free as cv2 writes them."""
    rng = np.random.RandomState(3)
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    ch = {"gray": 1, "rgb": 3, "rgba": 4}[kind.rstrip("1680")]
    img = rng.randint(0, np.iinfo(dtype).max + 1, (H, W, ch)).astype(dtype)[:, :, 0 if ch == 1 else slice(None)]
    for params in ([], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]):
        path = str(tmp_path / "c.png")
        assert cv2.imwrite(path, img, params)
        assert_like_cv2(path)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "P-trns", "P-2bit", "RGB", "RGBA", "I;16"])
def test_png_pil_written_equals_cv2(tmp_path, mode):
    """Files PIL writes: 1-bit, gray, gray + alpha, palette (8-bit with and
    without transparency, 2-bit), RGB, RGBA and 16-bit gray."""
    rng = np.random.RandomState(4)
    rgb = _gradient(H, W, 4)
    path = str(tmp_path / "pil.png")
    if mode == "1":
        Image.fromarray(rng.rand(H, W) > 0.5).save(path)
    elif mode == "I;16":
        Image.fromarray(rng.randint(0, 65536, (H, W)).astype(np.uint16)).save(path)
    elif mode.startswith("P"):
        im = Image.fromarray(rgb).quantize(4 if mode == "P-2bit" else 64)
        kw = {"bits": 2} if mode == "P-2bit" else {"transparency": bytes(range(0, 256, 9))} if mode == "P-trns" else {}
        im.save(path, **kw)
    else:
        Image.fromarray(rgb).convert(mode).save(path)
    assert_like_cv2(path)


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["intel", "motorola"])
def test_png_exif_orientation_equals_cv2(tmp_path, order):
    """An eXIf chunk with each orientation 1-8, little- and big-endian: cv2
    turns the image under IMREAD_COLOR only, and so does imread."""
    e = "<" if order == b"II" else ">"
    samples = np.random.RandomState(5).randint(0, 256, (7, 11, 3))
    for o in range(1, 9):
        tiff = (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
                + struct.pack(e + "HHIHH", 0x0112, 3, 1, o, 0) + struct.pack(e + "I", 0))
        assert_like_cv2(_write(tmp_path / f"e{o}.png", png_bytes(samples, 2, 8, exif=tiff)))


# -- JPEG ------------------------------------------------------------------------

PROGRESSIVE = [(w, s, r) for w in ("cv2", "pil") for s in ("444", "422", "420", "gray") for r in (0, 3)]


@pytest.mark.parametrize("writer,sampling,restart", PROGRESSIVE,
                         ids=[f"{w}-{s}{f'-rst{r}' if r else ''}" for w, s, r in PROGRESSIVE])
def test_progressive_jpeg_equals_cv2(tmp_path, writer, sampling, restart):
    """Progressive files (cv2 IMWRITE_JPEG_PROGRESSIVE, PIL progressive=True;
    libjpeg's standard scan script: DC first and refinement, AC bands and
    successive approximation with EOB runs) at each sampling and gray, with
    and without a restart interval, at 48x64 and at 37x53 (no multiple of
    the MCU), quality 75 and 95."""
    for hw in ((H, W), (37, 53)):
        rgb = _gradient(*hw, seed=hw[1])
        img = rgb[:, :, 1] if sampling == "gray" else rgb
        for q in (75, 95):
            if writer == "cv2":
                params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL,
                          restart]
                if sampling != "gray":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
                data = cv2_jpeg(img, *params)
            else:
                kw = {"restart_marker_blocks": restart} if restart else {}
                if sampling != "gray":
                    kw["subsampling"] = PIL_SUBSAMPLING[sampling]
                data = pil_jpeg(img, quality=q, progressive=True, **kw)
            assert data[2:].find(b"\xff\xc2") > 0 and (b"\xff\xdd" in data) == bool(restart)
            assert_like_cv2(_write(tmp_path / "p.jpg", data))


@pytest.mark.parametrize("kind", ["cmyk-444", "cmyk-420", "cmyk-progressive", "ycck", "cmyk-no-adobe"])
def test_four_component_jpeg_equals_cv2(tmp_path, kind):
    """CMYK files from PIL (Adobe marker, transform 0; 4:4:4, 4:2:0 on C,
    progressive), the same file as YCCK (transform 2) and without its Adobe
    marker (read as CMYK): converted as cv2 converts them."""
    rgb = _gradient(H, W, 6)
    kw = {"subsampling": 2} if kind == "cmyk-420" else {"progressive": True} if kind == "cmyk-progressive" else {}
    data = pil_jpeg(rgb, "CMYK", quality=90, **kw)
    at = data.find(b"\xff\xee")
    assert data[at + 4:at + 9] == b"Adobe" and data[at + 15] == 0
    if kind == "ycck":
        data = data[:at + 15] + b"\x02" + data[at + 16:]
    elif kind == "cmyk-no-adobe":
        (length,) = struct.unpack(">H", data[at + 2:at + 4])
        data = data[:at] + data[at + 2 + length:]
    assert_like_cv2(_write(tmp_path / "k.jpg", data))


def test_decoder_chosen_by_content(tmp_path):
    """A JPEG named -color.png and a PNG named .jpg read by what they hold,
    as cv2 reads them."""
    rgb = _gradient(H, W, 7)
    assert_like_cv2(_write(tmp_path / "000001-color.png", cv2_jpeg(rgb, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)))
    assert_like_cv2(_write(tmp_path / "bg.jpg", png_case(3, 4, True, True)))
    assert image_format((tmp_path / "000001-color.png").read_bytes()) == "JPEG"


# -- what raises -----------------------------------------------------------------

def _rewrite_marker(data: bytes, old: bytes, new: bytes) -> bytes:
    at = data.find(old)
    assert at > 0
    return data[:at] + new + data[at + 2:]


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "12-bit", "webp", "tiff", "jpeg2000", "missing",
                                  "smoothing"])
def test_rejections(tmp_path, case):
    """What imread does not read raises, naming the file and its kind: a
    baseline file with SOF0 rewritten as SOF9 (arithmetic-coded) or SOF3
    (lossless) or its precision as 12; WEBP, TIFF and JPEG 2000 files
    cv2 writes; a missing file (cv2.imread's None).  A progressive file
    without its last scan leaves the luma's lowest AC bits unknown: cv2
    smooths its blocks, so the decoder's plain result differs from cv2's,
    and imread raises."""
    rgb = _gradient(H, W, 8)
    base = cv2_jpeg(rgb)
    path = tmp_path / f"{case}.img"
    if case in ("arithmetic", "lossless", "12-bit"):
        if case == "12-bit":
            at = base.find(b"\xff\xc0")
            data = base[:at + 4] + b"\x0c" + base[at + 5:]
        else:
            data = _rewrite_marker(base, b"\xff\xc0", b"\xff\xc9" if case == "arithmetic" else b"\xff\xc3")
        _write(path, data)
        with pytest.raises(ValueError, match={"arithmetic": r"arithmetic-coded sequential JPEG \(SOF9\)",
                                              "lossless": r"lossless JPEG \(SOF3\)",
                                              "12-bit": "12-bit JPEG"}[case]) as err:
            imread(str(path), "color")
        assert str(path) in str(err.value)
    elif case in ("webp", "tiff", "jpeg2000"):
        ext, name = {"webp": (".webp", "WEBP"), "tiff": (".tiff", "TIFF"), "jpeg2000": (".jp2", "JPEG 2000")}[case]
        _write(path, cv2.imencode(ext, rgb[:, :, ::-1])[1].tobytes())
        assert cv2.imread(str(path)) is not None
        for mode in ("color", "unchanged"):
            with pytest.raises(ValueError, match=f"{path}: a {name} file"):
                imread(str(path), mode)
    elif case == "missing":
        assert cv2.imread(str(path)) is None
        with pytest.raises(FileNotFoundError, match=path.name):
            imread(str(path), "unchanged")
    else:
        data = cv2_jpeg(rgb, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        last = data.rfind(b"\xff\xda")
        _write(path, data[:last] + b"\xff\xd9")
        with pytest.raises(ValueError, match="smooths such blocks") as err:
            imread(str(path), "color")
        assert str(path) in str(err.value)
        plain = _Decoder(path.read_bytes(), str(path))
        plain.check_no_smoothing = lambda: None
        assert not np.array_equal(plain.decode("color"), cv2.imread(str(path))[:, :, ::-1])
    with pytest.raises(ValueError, match="mode must be"):
        imread(str(path), "grayscale")


# -- the port's sites against the JAX package's ---------------------------------

def _variants(root: Path) -> dict:
    """Colour, depth and label files in encodings the devkit writers never
    use, each under the devkit's own kind of name."""
    rng = np.random.RandomState(9)
    rgb = _gradient(H, W, 9)
    depth = rng.randint(0, 5000, (H, W, 1))
    label = rng.randint(0, 3, (H, W, 1))
    files = {
        "color": {
            "progressive": cv2_jpeg(rgb, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
            "cmyk": pil_jpeg(rgb, "CMYK"),
            "palette-adam7": png_case(3, 8, True, True, seed=1),
            "rgb16": png_bytes(rgb.astype(np.int64) * 257 + rng.randint(0, 257, rgb.shape), 2, 16),
            "gray-alpha": png_case(4, 8, False, False, seed=2),
            "gray4": png_case(0, 4, False, True, seed=3),
        },
        "depth": {
            "gray16-adam7": png_bytes(depth, 0, 16, interlace=True),
            "gray16-trns": png_bytes(depth, 0, 16, trns=struct.pack(">H", int(depth[0, 0, 0]))),
        },
        "label": {
            "gray8-adam7": png_bytes(label, 0, 8, interlace=True),
            "gray1": png_bytes(label > 0, 0, 1),
            "gray2-adam7": png_bytes(label, 0, 2, interlace=True),
        },
    }
    out = {}
    for kind, variants in files.items():
        for name, data in variants.items():
            out[kind, name] = str(_write(root / f"{name}-{kind}.png", data))
    return out


def test_preprocess_readers_equal_jax(tmp_path):
    """load_image_rgb, load_depth and load_label_mask on each variant file
    (a JPEG and a 16-bit RGB PNG among the colour files, Adam7 depths,
    1- and 2-bit labels): exactly the JAX package's arrays."""
    for (kind, name), path in _variants(tmp_path).items():
        if kind == "color":
            a, b = j_pre.load_image_rgb(path), t_pre.load_image_rgb(path)
        elif kind == "depth":
            a, b = j_pre.load_depth(path, 1000.0), t_pre.load_depth(path, 1000.0)
        else:
            a, b = j_pre.load_label_mask(path, 1), t_pre.load_label_mask(path, 1)
        assert a.dtype == b.dtype and a.shape == b.shape, (kind, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("texture", ["jpeg", "progressive", "palette"])
def test_textured_mesh_texture_equals_jax(tmp_path, texture):
    """load_textured_mesh with texture_map.png holding a JPEG (baseline,
    progressive) or a palette PNG: the same vertex colours and, with
    keep_texture, the same texture as the JAX package's."""
    tex = _gradient(32, 64, 10)
    t_mesh.write_textured_obj(str(tmp_path), t_mesh.make_uv_sphere(0.05, 8, 16, tex))
    data = {"jpeg": cv2_jpeg(tex), "progressive": cv2_jpeg(tex, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
            "palette": png_case(3, 8, False, True, seed=11, hw=(32, 64))}[texture]
    _write(tmp_path / "texture_map.png", data)
    a = j_mesh.load_textured_mesh(str(tmp_path), keep_texture=True)
    b = t_mesh.load_textured_mesh(str(tmp_path), keep_texture=True)
    for key in ("vertices", "faces", "colors", "uv", "texture"):
        x, y = np.asarray(getattr(a, key)), np.asarray(getattr(b, key))
        assert x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def test_stat_depth_equals_jax(tmp_path):
    """stat_depth over Adam7 and tRNS 16-bit depths: the JAX package's
    maximum and minimum."""
    files = _variants(tmp_path)
    pairdb = [{"depth_rendered": files["depth", name]} for name in ("gray16-adam7", "gray16-trns")]
    assert t_stats.stat_depth(pairdb) == j_stats.stat_depth(pairdb)


def test_adapt_images_masks_equal_jax(tmp_path):
    """adapt_images on a BOP scene whose instance masks are a 1-bit gray PNG,
    an Adam7 2-bit one and a progressive gray JPEG: the same labels and
    metadata as the JAX package's."""
    rng = np.random.RandomState(12)
    scene = tmp_path / "bop" / "000001"
    for sub in ("rgb", "depth", "mask"):
        (scene / sub).mkdir(parents=True)
    gt, info = {}, {}
    yy, xx = np.mgrid[0:H, 0:W]
    for frame in range(2):
        _write(scene / "rgb" / f"{frame:06d}.png", png_case(2, 8, False, False, seed=frame))
        _write(scene / "depth" / f"{frame:06d}.png", png_case(0, 16, False, False, seed=frame))
        gt[str(frame)], info[str(frame)] = [], []
        for ins in range(3):
            cy, cx = rng.randint(10, H - 10), rng.randint(10, W - 10)
            mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < 120)[:, :, None]
            data = (png_bytes(mask, 0, 1) if ins == 0 else png_bytes(mask * 3, 0, 2, interlace=True) if ins == 1
                    else cv2_jpeg((mask[:, :, 0] * 255).astype(np.uint8), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
            _write(scene / "mask" / f"{frame:06d}_{ins:06d}.png", data)
            gt[str(frame)].append({"obj_id": 1 + ins % 2, "cam_R_m2c": np.eye(3).flatten().tolist(),
                                   "cam_t_m2c": [0.0, 0.0, float(500 + 100 * ins)]})
            info[str(frame)].append({"bbox_visib": [cx - 10, cy - 10, 20, 20]})
    (scene / "scene_gt.json").write_text(json.dumps(gt))
    (scene / "scene_gt_info.json").write_text(json.dumps(info))
    j_adapt.adapt_images(str(tmp_path / "bop"), str(tmp_path / "jax"), ["cube"])
    t_adapt.adapt_images(str(tmp_path / "bop"), str(tmp_path / "port"), ["cube"])
    for frame in (1, 2):
        for suffix in ("label", "color", "depth"):
            rel = f"data/observed/01/{frame:06d}-{suffix}.png"
            a = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
            b = imread(str(tmp_path / "port" / rel), "unchanged")
            np.testing.assert_array_equal(a, b, err_msg=rel)
        label = imread(str(tmp_path / "port" / f"data/observed/01/{frame:06d}-label.png"), "unchanged")
        assert set(np.unique(label)) == {0, 1, 2}

