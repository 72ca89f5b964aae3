"""The learned-tracking path of the port against the JAX package, on the
CPU at a small size (64x64, subdiv 1, 2 classes, 3 frames):

* the noise mix: tools/synth_data.py's generate_dataset(noise_mix=) writes
  the devkit the JAX generator writes from the same seed, and
  sample_perturbed_pose takes the same noise arguments;
* tools/track_learned.py against experiments/track_learned.py: one random
  JAX checkpoint, converted by experiments/convert_orbax_checkpoint.py;
  the same trajectory and initial poses, the same frames, tracked poses and
  TRACK_JSON within twice JAX's own bf16-vs-float32 gap, and score_track
  equal to the JAX harness's scores given the same poses;
* tools/track_finetune.py against experiments/track_finetune.py: the same
  generate_dataset call and train_net Config, and the seed checkpoint where
  train_net resumes it.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import deepim_tpu.engine.tracker as j_tracker  # noqa: E402
import deepim_tpu.eval.evaluator as j_evaluator  # noqa: E402
import deepim_tpu.models as j_models  # noqa: E402
import deepim_tpu.tools.synth_data as j_synth  # noqa: E402
import deepim_tpu.tools.train_net as j_train_net  # noqa: E402
from deepim_tpu.data import pairdb as j_pairdb  # noqa: E402
from deepim_tpu.engine.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from deepim_tpu.engine.train import TrainState as JTrainState  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import checkpoint_path  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
from deepim_tpu_torch.tools import synth_data as t_synth  # noqa: E402
from deepim_tpu_torch.tools import track_finetune as t_ft  # noqa: E402
from deepim_tpu_torch.tools import track_learned as t_track  # noqa: E402
from deepim_tpu_torch.utils.png import read_png  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
RASTER = dict(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128, chunk=16, znear=0.05, zfar=10.0)
SMALL = ["--size", str(H), "--classes", "2", "--subdiv", "1"]
EPOCH = 1


def _jax_script(name: str):
    """experiments/<name>.py as a module (a script, not a package module)."""
    spec = importlib.util.spec_from_file_location(f"j_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_TRACK = _jax_script("track_learned")
J_FT = _jax_script("track_finetune")
CONVERTER = _jax_script("convert_orbax_checkpoint")


# -- the noise mix ---------------------------------------------------------------

NOISE_MODELS = {"default": ()} | {f"mix{i}": m[1:] for i, m in enumerate(t_ft.NOISE_MIX)}


@pytest.mark.parametrize("model", sorted(NOISE_MODELS))
def test_sample_perturbed_pose_equals_jax(model):
    """sample_perturbed_pose with each of the fine-tune's noise models (and
    the defaults) draws JAX's pose from the same RandomState."""
    pose = np.concatenate([np.eye(3, dtype=np.float32)[[1, 2, 0]], [[0.01], [-0.02], [0.6]]], 1).astype(np.float32)
    args = NOISE_MODELS[model]
    a = j_synth.sample_perturbed_pose(pose, np.random.RandomState(5), *args)
    b = t_synth.sample_perturbed_pose(pose, np.random.RandomState(5), *args)
    assert b.dtype == a.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert np.abs(b - pose).max() > 1e-4


def _listing(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def test_generate_dataset_noise_mix_equals_jax(tmp_path):
    """generate_dataset(noise_mix=) writes the JAX generator's devkit from
    the same seed: the same files, image lists and models text, pose files
    to 1e-6, labels equal, colour and depth within a level with equal hit
    masks (the rasterizers' tolerance, tests/test_csr_raster.py); and the
    mix draws initial poses other than the single model's."""
    j_root, t_root, plain = (str(tmp_path / d) for d in ("jax", "port", "plain"))
    kw = dict(n_train=3, n_val=2, height=H, width=W, z_range=(0.45, 0.75), seed=11)
    j_synth.generate_dataset(j_root, j_mesh.make_benchmark_classes(2, subdiv=1), K64,
                             raster_cfg=JRasterConfig(**RASTER), noise_mix=t_ft.NOISE_MIX, **kw)
    t_synth.generate_dataset(t_root, t_mesh.make_benchmark_classes(2, subdiv=1), K64,
                             raster_cfg=RasterConfig(**RASTER), noise_mix=t_ft.NOISE_MIX, device="cpu", **kw)
    files = _listing(j_root)
    assert _listing(t_root) == files
    n_pose = 0
    for rel in files:
        a_path, b_path = os.path.join(j_root, rel), os.path.join(t_root, rel)
        if rel.endswith("-pose.txt"):
            np.testing.assert_allclose(j_pairdb.load_pose_file(b_path), j_pairdb.load_pose_file(a_path), rtol=0,
                                       atol=1e-6, err_msg=rel)
            n_pose += 1
        elif not rel.endswith(".png"):
            assert Path(b_path).read_text() == Path(a_path).read_text(), rel
        else:
            a = cv2.imread(a_path, cv2.IMREAD_UNCHANGED).astype(np.int64)
            b = read_png(b_path).astype(np.int64)
            if a.ndim == 3:
                a = a[:, :, ::-1]
            assert a.shape == b.shape, rel
            if rel.endswith("-label.png"):
                np.testing.assert_array_equal(b, a, err_msg=rel)
            else:
                np.testing.assert_array_equal(b > 0, a > 0, err_msg=rel)
                assert np.abs(b - a).max() <= 1, rel
    assert n_pose == 2 * 2 * 5
    t_synth.generate_dataset(plain, t_mesh.make_benchmark_classes(2, subdiv=1), K64,
                             raster_cfg=RasterConfig(**RASTER), device="cpu", **kw)
    rel = "data/rendered/obj00/000000_0-pose.txt"
    gt_rel = "data/gt_observed/obj00/000000-pose.txt"
    np.testing.assert_array_equal(j_pairdb.load_pose_file(os.path.join(plain, gt_rel)),
                                  j_pairdb.load_pose_file(os.path.join(t_root, gt_rel)))
    assert not np.allclose(j_pairdb.load_pose_file(os.path.join(plain, rel)),
                           j_pairdb.load_pose_file(os.path.join(t_root, rel)))


# -- the tracking harness ------------------------------------------------------------


def _jax_params():
    """The full JAX network's parameters at 64x64 (numpy), with a random
    nonzero translation head so the tracked poses move."""
    params = JFlowNet(pred_flow=True, pred_mask=True).init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    return params


def _run_jax_track(argv: list[str], dtype) -> dict:
    """experiments/track_learned.py's main with `argv`, its network in
    `dtype`: the TRACK_JSON object, the tracker's frames, initial poses and
    tracked poses (caught inside its jit), and the ground-truth poses (the
    evaluator's ADD gets each class's track first)."""
    got = {"gt": []}
    real_make_tracker, real_add = j_tracker.make_tracker, j_evaluator._add_errors

    def spy_make_tracker(*args, **kwargs):
        track = real_make_tracker(*args, **kwargs)

        def keep(frames, pose0, poses):
            got.update(frames=np.asarray(frames), pose0=np.asarray(pose0), poses=np.asarray(poses))

        def wrapped(params, frames, mb, k, pose0):
            out = track(params, frames, mb, k, pose0)
            jax.debug.callback(keep, frames, pose0, out[1])
            return out
        return wrapped

    def spy_add(est, gt, pts):
        got["gt"].append(np.asarray(gt))
        return real_add(est, gt, pts)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_tracker, "make_tracker", spy_make_tracker)
        mp.setattr(j_evaluator, "_add_errors", spy_add)
        mp.setattr(j_models, "FlowNetDeepIM", lambda **kw: JFlowNet(**{**kw, "dtype": dtype}))
        mp.setattr(sys, "argv", ["track_learned.py", *argv])
        with contextlib.redirect_stdout(out):
            J_TRACK.main()
    line = next(x for x in out.getvalue().splitlines() if x.startswith("TRACK_JSON "))
    got["summary"] = json.loads(line[len("TRACK_JSON "):])
    got["poses_gt"] = np.stack(got.pop("gt")[::2], axis=1).astype(np.float32)  # a class's track, then its init
    return got


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    """One random JAX checkpoint tracked by both harnesses (2 iterations a
    frame, 2 lock-on iterations): the JAX harness in bf16 and in float32,
    the port's in bf16 on the CPU from the converted file."""
    root = tmp_path_factory.mktemp("track_learned")
    j_run, t_run = root / "jax_run", root / "port_run"
    j_save_checkpoint(str(j_run / "bench13"), EPOCH, JTrainState(_jax_params(), None, np.int32(3)))
    argv = [*SMALL, "--frames", "3", "--epochs", str(EPOCH), "--init-iters", "2", "--devkit", str(root / "devkit")]
    j16 = _run_jax_track([*argv, "--run-dir", str(j_run)], jnp.bfloat16)
    j32 = _run_jax_track([*argv, "--run-dir", str(j_run)], jnp.float32)
    cfg = update_config_dict(Config(), {"SCALES": [H, W], "network": {"INPUT_MASK": True, "PRED_FLOW": True,
                                                                      "PRED_MASK": True}})
    CONVERTER.convert(cfg, str(j_run / "bench13"), EPOCH, str(t_run / "bench13"))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        port = t_track.main([*argv, "--run-dir", str(t_run), "--device", "cpu"])
    port["stdout"] = out.getvalue()
    return j16, j32, port


def test_track_sequence_and_frames_equal_jax(tracks):
    """make_sequence draws JAX's trajectory and initial poses exactly (in
    float32); the port's rasterizer renders its frames within the
    rasterizers' tolerance (RGB 5e-3, equal coverage)."""
    j16, _, port = tracks
    poses_gt, pose0 = t_track.make_sequence(["obj00", "obj01"], 3)
    assert poses_gt.dtype == pose0.dtype == np.float32
    np.testing.assert_array_equal(poses_gt, j16["poses_gt"])
    np.testing.assert_array_equal(pose0, j16["pose0"])
    np.testing.assert_array_equal(port["poses_gt"], poses_gt)
    np.testing.assert_array_equal(port["pose0"], pose0)
    assert port["frames"].shape == j16["frames"].shape == (3, 2, 3, H, W)
    np.testing.assert_array_equal(port["frames"].max(1) > 0, j16["frames"].max(1) > 0)
    np.testing.assert_allclose(port["frames"], j16["frames"], rtol=0, atol=5e-3)
    assert (port["frames"] > 0).mean() > 0.02


def test_tracked_poses_equal_jax(tracks, record_property):
    """Every frame's tracked poses within twice JAX's own bf16-vs-float32
    gap at that frame (the bf16 tolerance of tests/test_torch_bf16.py)."""
    j16, j32, port = tracks
    assert port["poses_est"].shape == (3, 2, 3, 4)
    for t in range(3):
        err = float(np.abs(port["poses_est"][t] - j16["poses"][t]).max())
        gap = float(np.abs(j16["poses"][t] - j32["poses"][t]).max())
        record_property(f"frame{t}_err_over_jax_gap", err / gap)
        assert err <= 2 * gap, (t, err, gap)
    assert np.abs(port["poses_est"][0] - port["pose0"]).max() > 1e-4


def _numbers(summary: dict) -> dict:
    """The TRACK_JSON object's scores by key path (not its metadata)."""
    out = {k: v for k, v in summary.items() if k.startswith("mean_")}
    for row in summary["per_class"]:
        out.update({(row["class"], k): v for k, v in row.items() if k != "class"})
    return out


# A TRACK_JSON number's quantity: its tolerance is twice the largest change
# JAX's own numbers of that quantity (every class, mean, max and final)
# show between bf16 and float32 networks.
QUANTITIES = ("add_lt", "adi_lt", "add_over_d", "adi_over_d", "rot_deg", "trans_over_d")


def _quantity(key) -> str | None:
    name = key[1] if isinstance(key, tuple) else key
    return next((q for q in QUANTITIES if q in name), None)


def test_track_json_equals_jax(tracks, record_property):
    """The port's TRACK_JSON has the JAX object's keys in their order, equal
    metadata, and each number within twice JAX's own bf16-vs-float32 gap
    for its quantity (1e-6 where that gap is 0, as for a share of frames
    no pose comes near the threshold of); the port scores its own poses
    with score_track; stdout holds the object, the table and the track's
    figures."""
    j16, j32, port = tracks
    got, want = port["summary"], j16["summary"]
    assert list(got) == list(want) and [list(r) for r in got["per_class"]] == [list(r) for r in want["per_class"]]
    for key in ("frames", "iters_per_frame", "init_iters", "prefix", "epochs"):
        assert got[key] == want[key], key
    a, b, c = _numbers(got), _numbers(want), _numbers(j32["summary"])
    assert a.keys() == b.keys() and all(_quantity(k) for k in b)
    gaps = {}
    for key, v in b.items():
        gaps[_quantity(key)] = max(gaps.get(_quantity(key), 0.0), abs(v - c[key]))
    for key, v in b.items():
        gap = gaps[_quantity(key)]
        record_property(f"{key}_err_over_jax_gap", abs(a[key] - v) / gap if gap else 0.0)
        assert abs(a[key] - v) <= max(2 * gap, 1e-6), (key, a[key], v, c[key], gap)
    meshes = t_mesh.make_benchmark_classes(2, subdiv=1)
    _, own = t_track.score_track(port["poses_est"], port["poses_gt"], port["pose0"], [meshes["obj00"], meshes["obj01"]],
                                 ["obj00", "obj01"], iters_per_frame=2, init_iters=2, prefix="bench13", epochs=EPOCH)
    assert own == got
    assert "TRACK_JSON " + json.dumps(got) in port["stdout"]
    assert "| class | ADD<0.1d %frames |" in port["stdout"] and "raster_dropped 0" in port["stdout"]
    assert port["run"]["raster_dropped"] == 0 and port["run"]["frames_per_s"] > 0


def test_score_track_equals_jax(tracks):
    """score_track, given the JAX harness's poses, returns its TRACK_JSON
    to 1e-9."""
    j16, _, _ = tracks
    meshes = t_mesh.make_benchmark_classes(2, subdiv=1)
    rows, summary = t_track.score_track(j16["poses"], j16["poses_gt"], j16["pose0"], [meshes["obj00"], meshes["obj01"]],
                                        ["obj00", "obj01"], iters_per_frame=2, init_iters=2, prefix="bench13",
                                        epochs=EPOCH)
    want = j16["summary"]
    assert rows == summary["per_class"] and list(summary) == list(want)
    a, b = _numbers(summary), _numbers(want)
    assert a.keys() == b.keys()
    for key, v in b.items():
        assert abs(a[key] - v) <= 1e-9, key


# -- the fine-tune ---------------------------------------------------------------------

FT_FLAGS = [*SMALL, "--epochs", "3", "--finetune-epochs", "4", "--n-train", "4", "--batch", "4", "--lr", "2e-4"]


def _capture_finetune(mp, synth_owner, train_owner, store: dict) -> None:
    def generate(*args, **kwargs):
        store["generate"] = (args, kwargs)

    def train(cfg, output_dir=None, **kwargs):
        store["cfg"], store["output_dir"] = cfg, output_dir
        prefix = os.path.join(output_dir, cfg.TRAIN.model_prefix)
        store["seed"] = os.path.join(prefix + "_ckpt", str(cfg.TRAIN.begin_epoch))
        assert cfg.TRAIN.RESUME and os.path.exists(store["seed"])

    mp.setattr(synth_owner, "generate_dataset", generate)
    mp.setattr(train_owner, "train_net", train)


def test_finetune_equals_jax(tmp_path):
    """track_finetune hands generate_dataset the JAX runner's arguments
    (meshes, K, counts, size, depth range, raster settings, the noise mix,
    seed 11) and train_net a Config equal to the JAX runner's field for
    field, with the bench13 checkpoint copied to the trackft prefix at
    --epochs, where train_net resumes; and it prints the track_learned
    command for the fine-tuned checkpoint."""
    got = {"jax": {}, "port": {}}
    for side in got:
        bench = tmp_path / side / "bench13_2c_64_1"
        seed = bench / "run" / "bench13_ckpt" / "3"
        if side == "jax":
            seed.mkdir(parents=True)
            (seed / "payload").write_text("jax")
        else:
            seed.parent.mkdir(parents=True)
            seed.write_text("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(tmp_path / "jax"))
        _capture_finetune(mp, j_synth, j_train_net, got["jax"])
        mp.setattr(sys, "argv", ["track_finetune.py", *FT_FLAGS])
        with contextlib.redirect_stdout(io.StringIO()):
            J_FT.main()
        mp.setattr(tempfile, "tempdir", str(tmp_path / "port"))
        _capture_finetune(mp, t_ft, t_ft, got["port"])
        with contextlib.redirect_stdout(io.StringIO()) as out:
            t_ft.main([*FT_FLAGS, "--device", "cpu"])

    def rel(path, side):
        return os.path.relpath(path, tmp_path / side)

    j_cfg, t_cfg = got["jax"]["cfg"], got["port"]["cfg"]
    t_dict = json.loads(json.dumps(dataclasses.asdict(t_cfg)).replace(str(tmp_path / "port"), "<tmp>"))
    j_dict = json.loads(json.dumps(dataclasses.asdict(j_cfg)).replace(str(tmp_path / "jax"), "<tmp>"))
    assert t_dict == j_dict
    assert (t_cfg.TRAIN.begin_epoch, t_cfg.TRAIN.end_epoch, t_cfg.TRAIN.model_prefix) == (3, 7, "trackft")
    assert rel(got["port"]["output_dir"], "port") == rel(got["jax"]["output_dir"], "jax")
    assert rel(got["port"]["seed"], "port") == rel(got["jax"]["seed"], "jax")
    assert Path(got["port"]["seed"]).read_text() == "port"
    assert checkpoint_path(os.path.join(got["port"]["output_dir"], "trackft"), 3) == got["port"]["seed"]

    (j_args, j_kw), (t_args, t_kw) = got["jax"]["generate"], got["port"]["generate"]
    assert rel(t_args[0], "port") == rel(j_args[0], "jax") == "bench13_2c_64_1_trackft"
    assert list(t_args[1]) == list(j_args[1]) == ["obj00", "obj01"]
    for name in j_args[1]:
        for field in ("vertices", "faces", "colors"):
            assert np.array_equal(getattr(t_args[1][name], field), getattr(j_args[1][name], field))
    np.testing.assert_array_equal(t_args[2], j_args[2])
    j_raster, t_raster = j_kw.pop("raster_cfg"), t_kw.pop("raster_cfg")
    assert {f.name: getattr(t_raster, f.name) for f in dataclasses.fields(t_raster)} == {
        f.name: getattr(j_raster, f.name) for f in dataclasses.fields(t_raster)}
    assert t_kw.pop("device") == torch.device("cpu")
    assert t_kw == j_kw and t_kw["noise_mix"] == t_ft.NOISE_MIX and t_kw["seed"] == 11
    assert (f"python -m deepim_tpu_torch.tools.track_learned --size {H} --prefix trackft --run-dir "
            f"{got['port']['output_dir']} --epochs 7") in out.getvalue()
