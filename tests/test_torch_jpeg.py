"""The port's host readers on the CPU: utils/jpeg.py against cv2.imread on
files cv2.imwrite writes (bit for bit, on every encoding listed below;
tests/test_torch_imread.py holds the progressive and four-component
files); VOC background substitution in make_train_sample against the JAX
package's, with the same generators, on baseline pools and on a pool of
progressive and CMYK files; images_to_video on JPEG frames, baseline and
progressive, against the JAX package's; and the native mesh/points reader
(utils/native.py) against the port's Python parse and the JAX package's.

Tolerances: decoded images exactly equal to cv2.imread's.  A substituted
background is resized by torch's bilinear (the port's resize_to_size)
where JAX uses cv2.resize on float32: within 1e-4 of the range in
general (measured 2.4e-5 at VOC's sizes), and the training samples over
this test's pool exactly equal.  Video frames of same-sized JPEGs exactly
equal."""
import os
import random
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.toolkit.gen_video as j_gen_video  # noqa: E402
import deepim_tpu.tools.train_net as j_train_net  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.data import preprocess as j_pre  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.utils import native as j_native  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.data import preprocess as t_pre  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
import deepim_tpu_torch.toolkit.gen_video as t_gen_video  # noqa: E402
from deepim_tpu_torch.tools import train_net as t_train_net  # noqa: E402
from deepim_tpu_torch.tools.synth_data import generate_dataset  # noqa: E402
from deepim_tpu_torch.utils import native as t_native  # noqa: E402
from deepim_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg  # noqa: E402

torch.set_num_threads(2)

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
CLASSES = ("cube", "sphere")


def _image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8 RGB: uniform noise, or gradients with a little noise."""
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * xx / max(w - 1, 1), 255 * yy / max(h - 1, 1), 127 + 120 * np.sin(xx / 7 + yy / 11)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def _write(path, rgb: np.ndarray, *params) -> str:
    assert cv2.imwrite(str(path), rgb[:, :, ::-1] if rgb.ndim == 3 else rgb, list(params))
    return str(path)


def _assert_like_cv2(path: str):
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# -- the decoder ------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_decode_equals_cv2(tmp_path, kind, sampling, quality):
    """Baseline files at 4:4:4, 4:2:2 and 4:2:0, quality 50 and 95, at 75x101
    (no multiple of any MCU) and 16x16: equal to cv2.imread."""
    for h, w in ((75, 101), (16, 16)):
        _assert_like_cv2(_write(tmp_path / f"{h}.jpg", _image(kind, h, w), cv2.IMWRITE_JPEG_QUALITY, quality,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
def test_decode_restart_intervals_equal_cv2(tmp_path, sampling):
    """IMWRITE_JPEG_RST_INTERVAL (DRI and RSTn markers every 1 and 3 MCUs)
    at each sampling, 4:4:0 and 4:1:1 among them."""
    for ri in (1, 3):
        _assert_like_cv2(_write(tmp_path / f"r{ri}.jpg", _image("noise", 75, 101, ri), cv2.IMWRITE_JPEG_RST_INTERVAL,
                                ri, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


@pytest.mark.parametrize("case", ["optimize", "gray", "narrow"])
def test_decode_other_encodings_equal_cv2(tmp_path, case):
    """Optimized Huffman tables (IMWRITE_JPEG_OPTIMIZE), a grayscale file
    (expanded to three equal channels, as IMREAD_COLOR does) and images 1
    to 4 pixels wide at 4:2:0 (chroma of 2 samples or fewer is replicated,
    not filtered)."""
    if case == "optimize":
        _assert_like_cv2(_write(tmp_path / "o.jpg", _image("gradient", 75, 101), cv2.IMWRITE_JPEG_OPTIMIZE, 1))
    elif case == "gray":
        _assert_like_cv2(_write(tmp_path / "g.jpg", _image("noise", 75, 101)[:, :, 0]))
        _assert_like_cv2(_write(tmp_path / "g2.jpg", _image("gradient", 75, 101)[:, :, 1], cv2.IMWRITE_JPEG_QUALITY,
                                50))
    else:
        for w in (1, 2, 3, 4):
            _assert_like_cv2(_write(tmp_path / f"n{w}.jpg", _image("noise", 9, w, w),
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]))


def _exif_app1(orientation: int, order: bytes) -> bytes:
    e = "<" if order == b"II" else ">"
    tiff = (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["intel", "motorola"])
def test_decode_exif_orientation_equals_cv2(tmp_path, order):
    """An Exif APP1 segment with each orientation 1-8, little- and big-endian,
    spliced after SOI: turned and flipped as cv2.imread turns it."""
    data = cv2.imencode(".jpg", _image("noise", 30, 47)[:, :, ::-1])[1].tobytes()
    for o in range(1, 9):
        path = tmp_path / f"e{o}.jpg"
        path.write_bytes(data[:2] + _exif_app1(o, order) + data[2:])
        _assert_like_cv2(str(path))


def test_decode_rejects_what_it_does_not_decode(tmp_path):
    """A progressive file (raised before progressive decoding) now decodes
    equal to cv2.imread; an arithmetic-coded one (a baseline file whose
    SOF0 marker is rewritten as SOF9) raises, naming the file and its
    kind; so does a file that is no JPEG and one cut short in its header."""
    _assert_like_cv2(_write(tmp_path / "p.jpg", _image("noise", 32, 40), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    data = Path(_write(tmp_path / "a.jpg", _image("noise", 32, 40))).read_bytes()
    at = data.find(b"\xff\xc0")
    path = tmp_path / "sof9.jpg"
    path.write_bytes(data[:at] + b"\xff\xc9" + data[at + 2:])
    with pytest.raises(ValueError, match=r"sof9\.jpg: arithmetic-coded sequential JPEG \(SOF9\)"):
        read_jpeg(str(path))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n", "x.png")
    data = Path(_write(tmp_path / "b.jpg", _image("noise", 32, 40))).read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(data[:100], "cut.jpg")


# -- VOC backgrounds in the training samples ----------------------------------------

@pytest.fixture(scope="module")
def voc_devkit(tmp_path_factory):
    """A 64x64 devkit (cube and 80-face icosphere, 4 training pairs each,
    written by the port on the CPU) with a VOC pool in the reference layout:
    three JPEGs of other sizes and aspects (4:2:0, 4:4:4, and one with a
    restart interval) listed with label 1, one listed with -1."""
    path = str(tmp_path_factory.mktemp("LM6d_voc"))
    generate_dataset(path, {"cube": t_mesh.make_test_cube(0.08), "sphere": t_mesh.make_icosphere(0.05, 1)}, K64,
                     n_train=4, n_val=0, height=H, width=W, z_range=(0.45, 0.6),
                     raster_cfg=RasterConfig(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                             znear=0.05, zfar=10.0), device="cpu")
    voc = Path(path) / "VOCdevkit" / "VOC2012"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "JPEGImages").mkdir()
    lines = []
    for i, (hw, params) in enumerate([((75, 100), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]),
                                      ((90, 70), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]]),
                                      ((50, 96), [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])]):
        _write(voc / "JPEGImages" / f"bg{i:04d}.jpg", _image("gradient", *hw, seed=10 + i), *params)
        lines.append(f"bg{i:04d}  1")
    lines.append("bg9999 -1")
    (voc / "ImageSets" / "Main" / "diningtable_trainval.txt").write_text("\n".join(lines) + "\n")
    return path


def _voc_cfgs(devkit_path):
    d = {
        "SCALES": [H, W],
        "dataset": {
            "dataset": "LM6D_REFINE+LM6D_REFINE_SYN", "dataset_path": devkit_path, "root_path": devkit_path,
            "image_set": "train_+train_", "model_dir": os.path.join(devkit_path, "models"),
            "class_name": list(CLASSES), "INTRINSIC_MATRIX": K64.flatten().tolist(), "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {"INPUT_MASK": True},
        "train_iter": {"SE3_PM_LOSS": True, "NUM_3D_SAMPLE": 16},
        "TRAIN": {"INIT_MASK": "box_gt", "MASK_DILATE": True, "REPLACE_OBSERVED_BG_RATIO": 0.5},
    }
    return j_update(JConfig(), d), update_config_dict(Config(), d)


def test_voc_samples_equal_jax(voc_devkit):
    """make_train_sample with the VOC pool and REPLACE_OBSERVED_BG_RATIO 0.5,
    every record (half of them data_syn) twice with the same generators as
    the JAX package's: the same substitutions (every data_syn sample and
    the real ones whose draw fell below the ratio, the object's pixels
    kept) and every key exactly equal; the second pass reads each
    background from the DecodeCache."""
    jc, tc = _voc_cfgs(voc_devkit)
    (j_dbs, j_recs), (t_dbs, t_recs) = j_train_net.load_pairdbs(jc), t_train_net.load_pairdbs(tc)
    assert [r["data_syn"] for r in t_recs] == [r["data_syn"] for r in j_recs] == [False] * 8 + [True] * 8
    j_voc, t_voc = j_pre.VOCBackgrounds(voc_devkit), t_pre.VOCBackgrounds(voc_devkit)
    assert t_voc.bg_list == j_voc.bg_list == ["bg0000", "bg0001", "bg0002"]
    cache = t_pre.DecodeCache()
    replaced = []
    for rep in range(2):
        for i, rec in enumerate(t_recs):
            pts = t_dbs[0].points(rec["gt_class"])
            a = j_pre.make_train_sample(rec, jc, pts, random.Random(i), np.random.RandomState(i), j_voc)
            b = t_pre.make_train_sample(rec, tc, pts, random.Random(i), np.random.RandomState(i), t_voc, cache)
            plain = t_pre.make_train_sample(rec, tc, pts, random.Random(i), np.random.RandomState(i))
            assert set(a) == set(b)
            for k in a:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)
            changed = np.abs(b["image_observed"] - plain["image_observed"]).max(axis=0) > 0
            fg = b["mask_gt_observed"][0] > 0
            np.testing.assert_array_equal(b["image_observed"][:, fg], plain["image_observed"][:, fg])
            replaced.append(bool(changed.any()))
            if rec["data_syn"]:
                assert changed.any()
        if rep == 0:
            misses = cache.misses
    assert cache.misses == misses and cache.hits >= len(t_recs)
    real = replaced[:8]
    assert 0 < sum(real) < 8 and replaced[:16] == replaced[16:]
    assert all(("voc", os.path.join(t_voc.voc_root, f"JPEGImages/{b}.jpg")) in cache.data for b in t_voc.bg_list)


def test_voc_progressive_and_cmyk_samples_equal_jax(voc_devkit, tmp_path):
    """make_train_sample as in test_voc_samples_equal_jax, drawing from a
    pool of a progressive JPEG with a restart interval and a progressive
    CMYK one (PIL), at two of that pool's sizes: every key of every sample
    exactly equal to the JAX package's, both files drawn, and each cached
    background equal to cv2.imread's."""
    voc = tmp_path / "VOCdevkit" / "VOC2012"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "JPEGImages").mkdir()
    _write(voc / "JPEGImages" / "prog.jpg", _image("gradient", 75, 100, 20), cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
           cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    Image.fromarray(_image("gradient", 90, 70, 21)).convert("CMYK").save(voc / "JPEGImages" / "cmyk.jpg", "JPEG",
                                                                        quality=90, progressive=True)
    (voc / "ImageSets" / "Main" / "diningtable_trainval.txt").write_text("prog  1\ncmyk  1\n")
    jc, tc = _voc_cfgs(voc_devkit)
    (j_dbs, j_recs), (t_dbs, t_recs) = j_train_net.load_pairdbs(jc), t_train_net.load_pairdbs(tc)
    j_voc, t_voc = j_pre.VOCBackgrounds(str(tmp_path)), t_pre.VOCBackgrounds(str(tmp_path))
    assert t_voc.bg_list == j_voc.bg_list == ["prog", "cmyk"]
    cache = t_pre.DecodeCache()
    for i, rec in enumerate(t_recs):
        pts = t_dbs[0].points(rec["gt_class"])
        a = j_pre.make_train_sample(rec, jc, pts, random.Random(i), np.random.RandomState(i), j_voc)
        b = t_pre.make_train_sample(rec, tc, pts, random.Random(i), np.random.RandomState(i), t_voc, cache)
        assert set(a) == set(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
    for name in t_voc.bg_list:
        path = os.path.join(t_voc.voc_root, f"JPEGImages/{name}.jpg")
        np.testing.assert_array_equal(cache.data["voc", path], cv2.imread(path)[:, :, ::-1].astype(np.float32))


def test_voc_crop_and_resize_equals_cv2():
    """replace_background's resize against the JAX package's cv2.resize on
    the crops of both aspect branches, VOC's 500x375 and 500x333 among them:
    resize_to_size within 1e-4 of the range of cv2.resize(INTER_LINEAR) on
    float32, the rule of tests/test_torch_data.py's rounded sizes (torch
    maps by a float32 ratio, cv2 by a double one; measured 2.4e-5)."""
    rng = np.random.RandomState(4)
    for src, dst in (((75, 100), (64, 64)), ((50, 96), (48, 64)), ((375, 500), (480, 640)), ((333, 500), (480, 640))):
        img = (rng.rand(*src, 3) * 255).astype(np.float32)
        got = t_pre.resize_to_size(img, *dst)
        ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-4 * 255, rtol=0)


# -- images_to_video on JPEG frames ------------------------------------------------------

class _Recorder:
    """Stands in for cv2.VideoWriter: keeps each frame (RGB) it is given."""

    videos: list = []

    def __init__(self, path, fourcc, fps, size):
        self.frames = []
        _Recorder.videos.append(self)

    def write(self, frame_bgr):
        self.frames.append(np.array(frame_bgr[:, :, ::-1]))

    def release(self):
        pass


def test_images_to_video_jpeg_frames_equal_jax(tmp_path, monkeypatch):
    """JPEG frames (.jpg and .jpeg, 4:2:0 and 4:4:4, one gray) stacked as
    the JAX package stacks them through cv2.imread: the port's AVI frames
    equal the frames JAX hands cv2.VideoWriter."""
    _Recorder.videos = []
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder)
    paths = [_write(tmp_path / "0.jpg", _image("gradient", 48, 64, 1)),
             _write(tmp_path / "1.jpeg", _image("noise", 48, 64, 2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    SAMPLING["444"]),
             _write(tmp_path / "2.jpg", _image("gradient", 48, 64, 3)[:, :, 0])]
    j_gen_video.images_to_video(paths, str(tmp_path / "j.mp4"), fps=4.0)
    stats = t_gen_video.images_to_video(paths, str(tmp_path / "t.avi"), fps=4.0)
    (rec,) = _Recorder.videos
    cap = cv2.VideoCapture(str(tmp_path / "t.avi"))
    got = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        got.append(fr[:, :, ::-1])
    cap.release()
    assert stats["frames"] == len(got) == len(rec.frames) == 3
    for a, b in zip(got, rec.frames):
        np.testing.assert_array_equal(a, b)


def test_images_to_video_progressive_frames_equal_jax(tmp_path, monkeypatch):
    """Progressive JPEG frames (4:2:0 with restarts, 4:4:4, gray, and one
    under a .png name) stacked as the JAX package stacks them through
    cv2.imread: the port's AVI frames equal the frames JAX hands
    cv2.VideoWriter."""
    _Recorder.videos = []
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder)
    prog = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    paths = [_write(tmp_path / "0.jpg", _image("gradient", 48, 64, 4), *prog, cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
             _write(tmp_path / "1.jpg", _image("noise", 48, 64, 5), *prog, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    SAMPLING["444"]),
             _write(tmp_path / "2.jpg", _image("gradient", 48, 64, 6)[:, :, 0], *prog)]
    os.rename(paths[1], tmp_path / "1.png")
    paths[1] = str(tmp_path / "1.png")
    j_gen_video.images_to_video(paths, str(tmp_path / "j.mp4"), fps=4.0)
    stats = t_gen_video.images_to_video(paths, str(tmp_path / "t.avi"), fps=4.0)
    (rec,) = _Recorder.videos
    cap = cv2.VideoCapture(str(tmp_path / "t.avi"))
    got = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        got.append(fr[:, :, ::-1])
    cap.release()
    assert stats["frames"] == len(got) == len(rec.frames) == 3
    for a, b in zip(got, rec.frames):
        np.testing.assert_array_equal(a, b)


# -- the native mesh and points reader -----------------------------------------------

def _python_parse(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(t_mesh, "parse_obj_native", lambda p: None)
        return t_mesh.parse_obj(path)


@pytest.mark.parametrize("kind", ["obj", "textured_obj", "xyz"])
def test_native_reader_equals_python_and_jax(tmp_path, monkeypatch, kind):
    """utils/native.py's OBJ and points.xyz parse against the port's Python
    parse and the JAX package's reader: exactly equal arrays (a 1,280-face
    icosphere, a textured uv sphere and 500 points)."""
    if kind == "xyz":
        pts = np.random.RandomState(6).randn(500, 3).astype(np.float32)
        path = str(tmp_path / "points.xyz")
        np.savetxt(path, pts)
        got = t_native.load_points_xyz(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, pts)
        np.testing.assert_array_equal(got, j_native.load_points_xyz(path))
        np.testing.assert_array_equal(got, np.loadtxt(path).astype(np.float32).reshape(-1, 3))
        return
    if kind == "obj":
        path = str(tmp_path / "m.obj")
        t_mesh.write_obj(path, t_mesh.make_icosphere(0.05, 3))
    else:
        texture = (np.random.RandomState(7).rand(16, 32, 3) * 255).astype(np.uint8)
        t_mesh.write_textured_obj(str(tmp_path), t_mesh.make_uv_sphere(0.05, 8, 16, texture))
        path = str(tmp_path / "textured.obj")
    got = t_mesh.parse_obj(path)
    for a, b, c in zip(got, _python_parse(path, monkeypatch), j_mesh.parse_obj(path)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert t_native.parse_obj_native(str(tmp_path / "missing.obj")) is None
