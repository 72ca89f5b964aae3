"""The port's video pieces against the JAX package's cv2 path, on the CPU:
utils/edges.py:canny against cv2.Canny (exactly equal), utils/avi.py
read back by cv2's FFmpeg backend (frames exactly equal), and
toolkit/gen_video.py's overlay, composition, image stacking and
refinement videos against deepim_tpu/toolkit/gen_video.py, whose frames are
caught before cv2.VideoWriter encodes them (mp4v is lossy).  Where the
JAX path resizes with cv2 (11-bit fixed-point weights) frames agree
within one grey level; everything else is exact."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.toolkit.gen_video as j_gen_video  # noqa: E402
from deepim_tpu.data.pairdb import load_gt_pairdb as j_load_gt_pairdb  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.tools.train_net import build_mesh_bank as j_build_mesh_bank  # noqa: E402
from deepim_tpu_torch.data.pairdb import load_gt_pairdb  # noqa: E402
from deepim_tpu_torch.engine import MeshBuffers, render_at_pose  # noqa: E402
from deepim_tpu_torch.engine.refine import EngineConfig  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
import deepim_tpu_torch.toolkit.gen_video as t_gen_video  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_mesh_bank  # noqa: E402
from deepim_tpu_torch.utils.avi import read_avi_index, write_avi  # noqa: E402
from deepim_tpu_torch.utils.edges import canny  # noqa: E402
from test_torch_eval import devkit  # noqa: E402,F401
from test_torch_tracker import _driver_cfgs, _fast_weights  # noqa: E402

torch.set_num_threads(2)

SIZES = [(64, 64), (96, 128)]
GREEN = (0, 255, 0)


def _devkit_silhouettes(devkit_path, hw):
    """The devkit's objects rendered at their gt poses at (h, w) by the
    port: binary uint8 masks (0 / 255)."""
    from test_torch_eval import _cfgs

    _, tc = _cfgs(devkit_path)
    h, w = hw
    k = np.array([[80.0 * h / 64, 0, w / 2], [0, 80.0 * h / 64, h / 2], [0, 0, 1]], np.float32)
    bank = build_mesh_bank(tc)
    poses, cls = [], []
    for ci, c in enumerate(("cube", "sphere")):
        _, pairdb = load_gt_pairdb(tc, "LM6D_REFINE", f"val_{c}", c, devkit_path, devkit_path)
        poses += [r["pose_observed"] for r in pairdb]
        cls += [ci] * len(pairdb)
    ecfg = EngineConfig(height=h, width=w, raster=RasterConfig(height=h, width=w, tile_h=16, tile_w=16,
                                                               max_faces_per_tile=128, znear=0.05, zfar=10.0))
    _, _, mask = render_at_pose(MeshBuffers.gather(bank, cls, device="cpu"),
                                torch.from_numpy(np.stack(poses).astype(np.float32)), torch.from_numpy(k), ecfg,
                                device="cpu")
    return [(m[0].numpy() * 255).astype(np.uint8) for m in mask]


def _masks(kind, hw, devkit_path):
    h, w = hw
    rng = np.random.RandomState(h + w)
    if kind == "devkit":
        return _devkit_silhouettes(devkit_path, hw)
    if kind == "blobs":
        from scipy import ndimage

        return [((ndimage.gaussian_filter(rng.rand(h, w), s) > 0.5) * 255).astype(np.uint8) for s in (1, 2, 4)]
    if kind == "lines_points":
        out = []
        for _ in range(3):
            m = np.zeros((h, w), np.uint8)
            m[rng.randint(h), :] = 255
            m[:, rng.randint(w)] = 255
            m[rng.randint(h, size=5), rng.randint(w, size=5)] = 255
            out.append(m)
        return out
    if kind == "border":
        out = []
        for _ in range(3):
            m = np.zeros((h, w), np.uint8)
            m[:rng.randint(1, h), rng.randint(w - 1):] = 255  # touches the top and right borders
            m[rng.randint(h // 2, h):, :rng.randint(1, w)] = 255  # the bottom and left ones
            out.append(m)
        return out
    return [np.zeros((h, w), np.uint8), np.full((h, w), 255, np.uint8)]


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["devkit", "blobs", "lines_points", "border", "empty_full"])
def test_canny_equals_cv2(kind, hw, devkit):
    """utils/edges.canny(x, 50, 150) exactly equal to cv2.Canny(x, 50, 150),
    the call of the overlays, on binary silhouettes (0 / 255)."""
    for m in _masks(kind, hw, devkit):
        np.testing.assert_array_equal(canny(m, 50, 150), cv2.Canny(m, 50, 150))


def test_canny_equals_cv2_on_grey_images():
    """The same on random grey images, where every direction and both
    thresholds matter."""
    rng = np.random.RandomState(0)
    for hw in SIZES:
        for _ in range(4):
            img = rng.randint(0, 256, hw).astype(np.uint8)
            np.testing.assert_array_equal(canny(img, 50, 150), cv2.Canny(img, 50, 150))


def _rgb(rng, hw):
    return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)


def test_overlay_and_compose_equal_jax():
    """_edge_overlay and compose_frame equal the JAX package's: exactly
    when the zoom panels are already HxW (cv2.resize copies them), within
    one grey level when they are resized."""
    rng = np.random.RandomState(1)
    for hw in SIZES:
        obs = _rgb(rng, hw)
        mask = _masks("blobs", hw, None)[1].astype(np.float32) / 255.0
        np.testing.assert_array_equal(t_gen_video._edge_overlay(obs, mask), j_gen_video._edge_overlay(obs, mask))
        # float panels outside [0, 255], as the zoomed mean-subtracted images are
        rend, zo, zr = (rng.uniform(-60, 300, (*hw, 3)).astype(np.float32) for _ in range(3))
        np.testing.assert_array_equal(t_gen_video.compose_frame(obs, rend, mask, zo, zr),
                                      j_gen_video.compose_frame(obs, rend, mask, zo, zr))
        small = [rng.uniform(-60, 300, (hw[0] // 2 + 3, hw[1] // 2 - 1, 3)).astype(np.float32) for _ in range(2)]
        t_fr = t_gen_video.compose_frame(obs, rend, mask, *small).astype(int)
        j_fr = j_gen_video.compose_frame(obs, rend, mask, *small).astype(int)
        assert t_fr.shape == j_fr.shape == (2 * hw[0], 2 * hw[1], 3)
        assert np.abs(t_fr - j_fr).max() <= 1


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr[:, :, ::-1])
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


@pytest.mark.parametrize("hw,n,fps", [((64, 64), 5, 2.0), ((47, 70), 3, 10.0), ((31, 33), 1, 29.97)])
def test_write_avi_reads_back_in_cv2(tmp_path, hw, n, fps):
    """write_avi's file, read by cv2's FFmpeg backend: the same frames,
    count and frame rate; its own index reads back the same; odd sizes and
    odd-length chunks included."""
    frames = np.random.RandomState(n).randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    path = tmp_path / "v.avi"
    stats = write_avi(str(path), frames, fps)
    assert stats["frames"] == n and stats["bytes"] == path.stat().st_size
    got, got_fps = _read_video(path)
    assert len(got) == n and abs(got_fps - fps) < 1e-3
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    idx = read_avi_index(str(path))
    assert (idx["frames"], idx["height"], idx["width"], idx["fourcc"]) == (n, *hw, "MPNG")
    assert abs(idx["fps"] - fps) < 1e-3


def test_write_avi_refuses_other_names_and_sizes(tmp_path):
    frame = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match=r"\.avi"):
        write_avi(str(tmp_path / "v.mp4"), [frame], 2.0)
    assert not (tmp_path / "v.mp4").exists()
    with pytest.raises(ValueError, match="first one"):
        write_avi(str(tmp_path / "v.avi"), [frame, np.zeros((8, 9, 3), np.uint8)], 2.0)


class _Recorder:
    """Stands in for cv2.VideoWriter: keeps each frame (RGB) it is given."""

    videos: list = []

    def __init__(self, path, fourcc, fps, size):
        self.path, self.fps, self.size, self.frames = path, fps, size, []
        _Recorder.videos.append(self)

    def write(self, frame_bgr):
        self.frames.append(np.array(frame_bgr[:, :, ::-1]))

    def release(self):
        pass


@pytest.fixture
def recorder(monkeypatch):
    _Recorder.videos = []
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder)
    return _Recorder


@pytest.mark.parametrize("same_size", [True, False])
def test_images_to_video_equals_jax(tmp_path, recorder, same_size):
    """images_to_video on cv2-written PNGs: the frames the JAX package
    hands cv2.VideoWriter and the port's AVI frames, exactly equal when
    every image has the first one's size, within one grey level when some
    are resized.  A BMP file (cv2 reads it, the port does not) raises,
    naming its format."""
    rng = np.random.RandomState(2)
    paths = []
    for i, hw in enumerate([(48, 64), (48, 64) if same_size else (61, 50), (48, 64) if same_size else (30, 90)]):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, _rgb(rng, hw)[:, :, ::-1])
        paths.append(p)
    j_gen_video.images_to_video(paths, str(tmp_path / "j.mp4"), fps=4.0)
    stats = t_gen_video.images_to_video(paths, str(tmp_path / "t.avi"), fps=4.0)
    (rec,) = recorder.videos
    got, fps = _read_video(tmp_path / "t.avi")
    assert stats["frames"] == len(got) == len(rec.frames) == 3 and fps == 4.0
    for a, b in zip(got, rec.frames):
        diff = np.abs(a.astype(int) - b.astype(int)).max()
        assert diff == 0 if same_size else diff <= 1, diff
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, _rgb(rng, (8, 8)))  # read by content now: the file must exist to be refused as a BMP
    with pytest.raises(ValueError, match="a BMP file; imread reads PNG and JPEG"):
        t_gen_video.images_to_video([bmp], str(tmp_path / "x.avi"))


@pytest.mark.parametrize("mode", ["iter_zoom", "iter", "single"])
def test_gen_refine_video_equals_jax(devkit, tmp_path, recorder, mode):
    """gen_refine_video on the devkit's sphere pairs (3 of 5, 4 iterations),
    fp32 FAST_TEST networks with the same weights: the same videos and
    frame counts, frames within one grey level and the green edge pixels
    exactly equal (the hit masks are exact)."""
    jc, tc = _driver_cfgs(devkit)
    params, model = _fast_weights((64, 64))
    _, j_pairdb = j_load_gt_pairdb(jc, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit)
    _, t_pairdb = load_gt_pairdb(tc, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit)
    j_gen_video.gen_refine_video(jc, params, JFlowNet(pred_flow=False, pred_mask=False, dtype=jnp.float32),
                                 j_pairdb, j_build_mesh_bank(jc), str(tmp_path / "j.mp4"), num_pairs=3, mode=mode)
    with torch.no_grad():
        stats = t_gen_video.gen_refine_video(tc, model, t_pairdb, build_mesh_bank(tc), str(tmp_path / "v.avi"),
                                             num_pairs=3, mode=mode, device="cpu")
    paths = [tmp_path / f"v_s{j}.avi" for j in range(3)] if mode == "single" else [tmp_path / "v.avi"]
    assert len(recorder.videos) == len(paths) == stats["videos"]
    assert stats["frames"] == 12 and min(stats[k] for k in ("render_s", "compose_s", "encode_s", "write_s")) > 0
    for rec, path in zip(recorder.videos, paths):
        got, fps = _read_video(path)
        assert len(got) == len(rec.frames) == (4 if mode == "single" else 12) and fps == 2.0
        for a, b in zip(got, rec.frames):
            assert a.shape == b.shape == ((64, 128, 3) if mode == "iter" else (128, 128, 3))
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            np.testing.assert_array_equal((a[:64, :64] == GREEN).all(-1), (b[:64, :64] == GREEN).all(-1))


def test_gen_video_cli(devkit, tmp_path):
    """python -m deepim_tpu_torch.toolkit.gen_video with --device cpu writes
    the video; without it, on a host with no CUDA device, it raises."""
    from test_torch_tracker import _write_cfg

    cfg_file = _write_cfg(devkit, tmp_path)
    out = tmp_path / "v.avi"
    stats = t_gen_video.main(["--cfg", cfg_file, "--cls", "cube", "--out", str(out), "--num-pairs", "2",
                              "--device", "cpu"])
    assert stats["frames"] == 8 and read_avi_index(str(out))["frames"] == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            t_gen_video.main(["--cfg", cfg_file, "--cls", "cube", "--out", str(out)])
