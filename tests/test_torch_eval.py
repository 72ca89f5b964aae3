"""Parity of the port's eval driver (eval/evaluator.py, engine/tester.py,
tools/test_net.py) with the JAX package's on the CPU, on a 64x64
LINEMOD-layout devkit written by the JAX generate_dataset (a cube and an
80-face icosphere, 5 test pairs a class, batches of 4 so the last one is
padded; one pair's initial pose is the all -1 sentinel).  Both packages
run fp32 networks with the same weights (models/convert.py) and a random
nonzero translation head.  Tolerances: evaluator tables 1e-6; refined
poses 2e-4 per iteration over 4 iterations; pass counts (accuracies)
equal and mean errors 1e-4; flow EPE relative 1e-5 (1e-3 at the last
iteration, see its test)."""
import logging
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.models as j_models  # noqa: E402
import deepim_tpu.tools.test_net as j_test_net  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.data.pairdb import load_gt_pairdb as j_load_gt_pairdb  # noqa: E402
from deepim_tpu.engine import tester as j_tester  # noqa: E402
from deepim_tpu.eval.evaluator import PoseEvaluator as JPoseEvaluator  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.synth_data import generate_dataset as j_generate  # noqa: E402
from deepim_tpu.tools.train_net import build_mesh_bank as j_build_mesh_bank  # noqa: E402
from deepim_tpu.tools.train_net import build_model as j_build_model  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.data.pairdb import load_gt_pairdb, save_pose_file  # noqa: E402
from deepim_tpu_torch.engine import tester as t_tester  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from deepim_tpu_torch.engine.train import TrainState  # noqa: E402
from deepim_tpu_torch.eval.evaluator import PoseEvaluator  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM, state_dict_from_flax  # noqa: E402
import deepim_tpu_torch.tools.test_net as t_test_net  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_deepim as t_test_deepim  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model  # noqa: E402
from deepim_tpu_torch.utils.avi import read_avi_index  # noqa: E402
from deepim_tpu_torch.utils.imread import image_format  # noqa: E402
from deepim_tpu_torch.utils.logger import logger as t_logger  # noqa: E402
from test_torch_imread import png_bytes  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
CLASSES = ("cube", "sphere")
SENTINEL = ("cube", "000004_0")  # this pair's initial pose is the no-detection sentinel
PREFIX = "deepim_synth"
TEST_EPOCH = 2


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("LM6d_refine_eval"))
    j_generate(path, {"cube": j_mesh.make_test_cube(0.08), "sphere": j_mesh.make_icosphere(0.05, 1)}, K64,
               n_train=1, n_val=5, height=H, width=W, z_range=(0.45, 0.6),
               raster_cfg=JRasterConfig(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                        chunk=16, znear=0.05, zfar=10.0))
    rend = Path(path) / "data" / "rendered"
    save_pose_file(str(rend / SENTINEL[0] / f"{SENTINEL[1]}-pose.txt"), -np.ones((3, 4), np.float32))
    # Precomputed "ICP" poses next to each rendered depth: the initial pose
    # moved 3 mm closer to the gt.
    rng = np.random.RandomState(5)
    for pose_file in sorted(rend.glob("*/*-pose.txt")):
        pose = np.loadtxt(pose_file, skiprows=1).reshape(3, 4)
        pose[:, 3] += rng.uniform(-0.003, 0.003, 3)
        save_pose_file(str(pose_file).replace("-pose.txt", "-pose_icp.txt"), pose)
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
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True,
                    "PIXEL_MEANS": [123.68, 116.779, 103.939]},
        "TRAIN": {"model_prefix": PREFIX},
        "TEST": {"test_iter": 4, "test_epoch": TEST_EPOCH, **test},
    }


def _cfgs(devkit_path, **test):
    d = _cfg_dict(devkit_path, **test)
    return j_update(JConfig(), d), update_config_dict(Config(), d)


def _class_dbs(jc, tc, devkit_path):
    j = [j_load_gt_pairdb(jc, "LM6D_REFINE", f"val_{c}", c, devkit_path, devkit_path) for c in CLASSES]
    t = [load_gt_pairdb(tc, "LM6D_REFINE", f"val_{c}", c, devkit_path, devkit_path) for c in CLASSES]
    return j, t


@pytest.fixture(scope="module")
def weights():
    """Full-model JAX params (numpy) with a random nonzero translation
    head, and the port's full model loaded from them."""
    params = JFlowNet(pred_flow=True, pred_mask=True).init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    model = FlowNetDeepIM(input_hw=(H, W), device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return params, model.eval()


def _fast_model(model):
    fast = FlowNetDeepIM(input_hw=(H, W), pred_flow=False, pred_mask=False, device="cpu").eval()
    fast.load_state_dict(model.state_dict(), strict=False)
    return fast


def _assert_tables(j_res, t_res, err_atol=1e-4):
    """Equal pass counts (accuracies) in every table and iteration; the
    error arrays' means to err_atol; everything else to 1e-6."""
    for table in ("pose", "add", "arp_2d"):
        assert set(j_res[table]) == set(t_res[table]), table
        for cls, by_iter in j_res[table].items():
            assert set(by_iter) == set(t_res[table][cls])
            for it, row in by_iter.items():
                trow = t_res[table][cls][it]
                assert set(row) == set(trow)
                for key, v in row.items():
                    if key == "errors":
                        assert abs(float(np.mean(v)) - float(np.mean(trow[key]))) <= err_atol, (table, cls, it)
                    elif key in ("rot_acc", "trans_acc", "space_acc", "curve", "curve_thresholds"):
                        np.testing.assert_allclose(trow[key], v, atol=1e-6, rtol=0, err_msg=f"{table} {cls} {key}")
                    else:
                        assert trow[key] == pytest.approx(v, abs=1e-6), (table, cls, it, key)


def _only_numpy(obj):
    if isinstance(obj, (list, tuple)):
        return all(_only_numpy(x) for x in obj)
    return isinstance(obj, np.ndarray)


def _random_poses(rng, n):
    from scipy.spatial.transform import Rotation

    rot = Rotation.random(n, random_state=rng).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.5, 0.9, n)], 1)
    return np.concatenate([rot, t[:, :, None]], 2).astype(np.float32)


@pytest.mark.parametrize("method", ["evaluate_pose", "evaluate_pose_add", "evaluate_pose_arp_2d"])
def test_pose_evaluator_equals_jax(method):
    """Each evaluator's tables equal the JAX package's to 1e-6 on random
    poses near and far from the gt, for an ADD class and the two
    symmetric (ADI) classes, eggbox with its 180-degree retry."""
    rng = np.random.RandomState(0)
    classes = ["ape", "eggbox", "glue"]
    points = {c: rng.uniform(-0.05, 0.05, (200, 3)).astype(np.float32) for c in classes}
    diameters = {c: 0.1 for c in classes}
    est, gt = [], []
    for _ in classes:
        g = _random_poses(rng, 40)
        e = g.copy()
        e[:20, :, 3] += rng.normal(0, 0.01, (20, 3))
        e[20:] = _random_poses(rng, 20)
        gt.append([list(g), list(g)])
        est.append([list(e), list(g + rng.normal(0, 1e-3, g.shape).astype(np.float32))])
    t = getattr(PoseEvaluator(classes, points, diameters, K64, 2), method)(est, gt)
    j = getattr(JPoseEvaluator(classes, points, diameters, K64, 2), method)(est, gt)
    for cls in classes:
        for it in (0, 1):
            for key, v in j[cls][it].items():
                np.testing.assert_allclose(np.asarray(t[cls][it][key]), np.asarray(v), atol=1e-6, rtol=0,
                                           err_msg=f"{cls} {it} {key}")


def test_pred_eval_equals_jax(devkit, weights, tmp_path):
    """pred_eval of both packages (FAST_TEST fp32 models, same weights):
    per-iteration poses to 2e-4, the sentinel pair left at its sentinel,
    equal tables; the port's cache holds only numpy arrays, the JAX
    pred_eval evaluates it unchanged, and a second port run refines
    nothing."""
    params, model = weights
    jc, tc = _cfgs(devkit, FAST_TEST=True)
    jdbs, tdbs = _class_dbs(jc, tc, devkit)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    j_res = j_tester.pred_eval(jc, params, JFlowNet(pred_flow=False, pred_mask=False), jdbs,
                               j_build_mesh_bank(jc), out_j, batch_size=4)
    t_res = t_tester.pred_eval(tc, _fast_model(model), tdbs, build_mesh_bank(tc), out_t, batch_size=4,
                               device="cpu")
    assert t_res["run"]["pairs"] == 10 and t_res["run"]["raster_dropped"] == 0
    with open(os.path.join(out_j, "results_pose.pkl"), "rb") as f:
        j_est, j_gt = pickle.load(f)
    with open(os.path.join(out_t, "results_pose.pkl"), "rb") as f:
        cache = pickle.load(f)
    assert _only_numpy(cache)
    t_est, t_gt = cache
    for ci in range(len(CLASSES)):
        for it in range(4):
            assert len(t_est[ci][it]) == len(j_est[ci][it]) == 5
            np.testing.assert_allclose(np.stack(t_est[ci][it]), np.stack(j_est[ci][it]), atol=2e-4, rtol=0)
            np.testing.assert_array_equal(np.stack(t_gt[ci][it]), np.stack(j_gt[ci][it]))
    ci = CLASSES.index(SENTINEL[0])
    pos = next(i for i, r in enumerate(tdbs[ci][1]) if r["image_rendered"].endswith(f"{SENTINEL[1]}-color.png"))
    for it in range(4):
        np.testing.assert_array_equal(t_est[ci][it][pos], -np.ones((3, 4), np.float32))
    moved = np.abs(np.stack(t_est[1][3]) - np.stack(t_est[1][0])).max()
    assert moved > 1e-4  # the refinement moved the poses
    _assert_tables(j_res, t_res)
    for it in range(4):
        assert (Path(out_t) / f"proj2d_curves_iter{it + 1}.txt").read_text() == \
            (Path(out_j) / f"proj2d_curves_iter{it + 1}.txt").read_text()

    shared = str(tmp_path / "shared")
    shutil.copytree(out_t, shared)
    _assert_tables(j_tester.pred_eval(jc, None, None, jdbs, None, shared), t_res, err_atol=0.0)
    again = t_tester.pred_eval(tc, None, tdbs, build_mesh_bank(tc), out_t, device="cpu")
    assert "run" not in again
    _assert_tables(again, t_res, err_atol=0.0)


class _Records(logging.Handler):
    """Collects the messages of the port's logger (it does not propagate)."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _fp32_jax_networks(monkeypatch):
    """The JAX test driver with fp32 networks (it builds bf16 ones)."""
    monkeypatch.setattr(j_test_net, "build_model", lambda cfg: j_build_model(cfg, dtype=jnp.float32))
    monkeypatch.setattr(j_models, "FlowNetDeepIM", lambda **kw: JFlowNet(**{**kw, "dtype": jnp.float32}))


def test_test_deepim_end_to_end(devkit, weights, tmp_path, monkeypatch):
    """test_deepim in both packages, fp32 networks in both: the port loads
    the full checkpoint it saved into its FAST_TEST model, the JAX driver
    gets the same params; equal tables.  Without a checkpoint the port warns and uses its
    initial weights; a checkpoint that does not fit raises."""
    params, model = weights
    jc, tc = _cfgs(devkit, FAST_TEST=True)
    out_t = tmp_path / "port"
    save_checkpoint(str(out_t / PREFIX), TEST_EPOCH, TrainState(model, None, 11))
    _fp32_jax_networks(monkeypatch)
    monkeypatch.setattr(t_test_net, "EVAL_DTYPE", torch.float32)
    j_res = j_test_net.test_deepim(jc, output_dir=str(tmp_path / "jax"), params=params, batch_size=4)
    t_res = t_test_deepim(tc, output_dir=str(out_t), batch_size=4, device="cpu")
    _assert_tables(j_res, t_res)
    assert "flow_epe" not in t_res
    run = t_res["run"]
    assert run["pairs"] == 10 and run["raster_dropped"] == 0
    for key in ("data_s", "net_s", "eval_s", "model_s", "bank_s", "pairdb_s", "pred_eval_s"):
        assert run[key] > 0, key
    assert run["pred_eval_s"] >= run["data_s"] + run["net_s"] + run["eval_s"]

    records = _Records()
    t_logger.addHandler(records)
    try:
        init_res = t_test_deepim(tc, output_dir=str(tmp_path / "fresh"), batch_size=8, device="cpu")
    finally:
        t_logger.removeHandler(records)
    assert any("using init params" in m for m in records.messages) and "pose" in init_res

    wrong = FlowNetDeepIM(input_hw=(96, 128), device="cpu")
    save_checkpoint(str(tmp_path / "wrong" / PREFIX), TEST_EPOCH, TrainState(wrong, None))
    with pytest.raises(RuntimeError, match="size mismatch"):
        t_test_deepim(tc, output_dir=str(tmp_path / "wrong"), batch_size=4, device="cpu")


def test_test_deepim_variant_devkit_equals_jax(devkit, weights, tmp_path, monkeypatch):
    """test_deepim in both packages (fp32 networks, as in
    test_test_deepim_end_to_end) on a copy of the devkit with the same file
    names and other encodings: every colour file a progressive JPEG, every
    depth an Adam7 16-bit gray PNG, every label an Adam7 8-bit gray PNG.
    The JAX package reads them with cv2.imread, the port with its own
    decoders: poses to 2e-4 per iteration and equal tables."""
    variant = tmp_path / "variant"
    shutil.copytree(devkit, variant, ignore=shutil.ignore_patterns("cache", "output"))
    kinds = {"color": 0, "depth": 0, "label": 0}
    for path in sorted(variant.glob("data/*/*/*.png")):
        kind = path.stem.rsplit("-", 1)[-1]
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if kind == "color":
            data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        elif kind in ("depth", "label"):
            data = png_bytes(img[:, :, None], 0, 16 if kind == "depth" else 8, interlace=True)
        else:
            continue
        path.write_bytes(data)
        kinds[kind] += 1
    assert min(kinds.values()) >= 10, kinds
    params, model = weights
    jc, tc = _cfgs(str(variant), FAST_TEST=True)
    _, tdbs = _class_dbs(jc, tc, str(variant))
    rec = tdbs[0][1][0]
    assert rec["image_observed"].startswith(str(variant))
    assert image_format(Path(rec["image_observed"]).read_bytes()) == "JPEG"
    out_t = tmp_path / "port"
    save_checkpoint(str(out_t / PREFIX), TEST_EPOCH, TrainState(model, None, 11))
    _fp32_jax_networks(monkeypatch)
    monkeypatch.setattr(t_test_net, "EVAL_DTYPE", torch.float32)
    out_j = tmp_path / "jax"
    j_res = j_test_net.test_deepim(jc, output_dir=str(out_j), params=params, batch_size=4)
    t_res = t_test_deepim(tc, output_dir=str(out_t), batch_size=4, device="cpu")
    assert t_res["run"]["pairs"] == 10 and t_res["run"]["raster_dropped"] == 0
    _assert_tables(j_res, t_res)
    with open(out_j / "results_pose.pkl", "rb") as f:
        j_est, _ = pickle.load(f)
    with open(out_t / "results_pose.pkl", "rb") as f:
        t_est, _ = pickle.load(f)
    for ci in range(len(CLASSES)):
        for it in range(4):
            np.testing.assert_allclose(np.stack(t_est[ci][it]), np.stack(j_est[ci][it]), atol=2e-4, rtol=0)


def test_test_deepim_bf16_default_equals_jax(devkit, weights, tmp_path, record_property):
    """test_deepim as both packages run it by default: bf16 networks, the
    image zoom float32 on the CPU (the JAX package's CPU choice, and the
    port's for device="cpu").  The port loads the checkpoint it saved, the
    unpatched JAX driver gets the same params.  The two bf16 networks'
    poses differ by bf16 roundings (tests/test_torch_bf16.py), so (fp32
    networks agree to 1e-4 in the error means): every accuracy at the tables' thresholds (5cm5deg, ADD(-S)
    at 0.02/0.05/0.10 d, Proj2D at 2/5/10/20 px) equal; the error arrays'
    means to 2e-3; each accuracy curve on its fine threshold grid apart in
    at most 4 grid points, by one pair each (100 / 5 pairs), and its AUC
    to 0.2 (one pair crossing one Proj2D grid point moves it by 0.053).  The
    largest difference of each kind goes to the test report."""
    params, model = weights
    jc, tc = _cfgs(devkit, FAST_TEST=True)
    out_t = tmp_path / "port"
    save_checkpoint(str(out_t / PREFIX), TEST_EPOCH, TrainState(model, None, 11))
    j_res = j_test_net.test_deepim(jc, output_dir=str(tmp_path / "jax"), params=params, batch_size=4)
    t_res = t_test_deepim(tc, output_dir=str(out_t), batch_size=4, device="cpu")
    assert t_test_net.EVAL_DTYPE == torch.bfloat16
    worst = {}
    for table in ("pose", "add", "arp_2d"):
        assert set(j_res[table]) == set(t_res[table]), table
        for cls, by_iter in j_res[table].items():
            assert set(by_iter) == set(t_res[table][cls])
            for it, row in by_iter.items():
                trow = t_res[table][cls][it]
                assert set(row) == set(trow)
                for key, v in row.items():
                    where = (table, cls, it, key)
                    diff = float(np.abs(np.mean(v) - np.mean(trow[key])) if key == "errors" else
                                 np.abs(np.asarray(trow[key], np.float64) - np.asarray(v, np.float64)).max())
                    name = f"{table}_{'errors_mean' if key == 'errors' else key}_max_diff"
                    worst[name] = max(worst.get(name, 0.0), diff)
                    if key == "errors":
                        assert abs(float(np.mean(v)) - float(np.mean(trow[key]))) <= 2e-3, where
                    elif key == "curve":
                        diff = np.abs(np.asarray(trow[key]) - np.asarray(v))
                        assert (diff > 1e-6).sum() <= 4 and diff.max() <= 100.0 / 5 + 1e-6, where
                    elif key == "auc":
                        assert abs(trow[key] - v) <= 0.2, where
                    else:
                        np.testing.assert_array_equal(trow[key], v, err_msg=str(where))
    for name, diff in sorted(worst.items()):
        record_property(name, diff)
    assert t_res["run"]["pairs"] == 10 and t_res["run"]["raster_dropped"] == 0


@pytest.mark.parametrize("fast_test,saved", [(True, True), (True, False), (False, True)])
def test_test_deepim_eval_model(devkit, weights, tmp_path, monkeypatch, fast_test, saved):
    """The one network test_deepim builds: FAST_TEST's heads only, on the
    requested device, holding the checkpoint's tensors exactly or, without
    a checkpoint, build_model's seeded initial weights."""
    _, model = weights
    _, tc = _cfgs(devkit, FAST_TEST=fast_test)
    if saved:
        save_checkpoint(str(tmp_path / PREFIX), TEST_EPOCH, TrainState(model, None))
    seen = []
    monkeypatch.setattr(t_test_net, "pred_eval", lambda cfg, m, *a, **kw: seen.append(m) or {})
    monkeypatch.setattr(t_test_net, "eval_flow_epe", lambda *a, **kw: {})
    t_test_deepim(tc, output_dir=str(tmp_path), device="cpu")
    (got,) = seen
    assert (got.pred_flow, got.pred_mask) == (not fast_test, not fast_test)
    ref = (model if saved else build_model(tc, device="cpu")).state_dict()
    sd = got.state_dict()
    assert sd and set(sd) <= set(ref)
    for k, v in sd.items():
        assert v.device.type == "cpu" and torch.equal(v, ref[k]), k


def test_eval_flow_epe_equals_jax(devkit, weights):
    """Flow EPE of the full network over 4 iterations, per iteration:
    relative 1e-5 of the JAX package's for iterations 1-3 and 1e-3 for
    iteration 4, whose source poses differ between the packages by enough
    (~1e-6) to flip a silhouette pixel of a render, which moves that
    pixel's flow label by pixels (measured: 3e-4 relative at iteration 4,
    under 4e-7 before it)."""
    params, model = weights
    jc, tc = _cfgs(devkit, FAST_TEST=False)
    jdbs, tdbs = _class_dbs(jc, tc, devkit)
    j = j_tester.eval_flow_epe(jc, params, JFlowNet(), jdbs, j_build_mesh_bank(jc), batch_size=4)
    t = t_tester.eval_flow_epe(tc, model, tdbs, build_mesh_bank(tc), batch_size=4, device="cpu")
    assert len(t["per_iter"]) == len(j["per_iter"]) == 4
    for it, (trow, jrow) in enumerate(zip(t["per_iter"] + [t], j["per_iter"] + [j])):
        for key in ("epe_all", "epe_viz", "epe_vizbg"):
            rel = 1e-3 if it == 3 else 1e-5
            assert trow[key] == pytest.approx(float(jrow[key]), rel=rel), (it, key)
    assert t["epe_viz"] > 0


@pytest.mark.parametrize("flag", ["PRECOMPUTED_ICP", "BEFORE_ICP"])
def test_precomputed_poses_equal(devkit, tmp_path, flag):
    """TEST.PRECOMPUTED_ICP / BEFORE_ICP through the port's test_deepim
    equal the JAX package's eval_precomputed_poses."""
    jc, tc = _cfgs(devkit, **{flag: True})
    jdbs, _ = _class_dbs(jc, tc, devkit)
    j_res = j_tester.eval_precomputed_poses(jc, jdbs, icp=flag == "PRECOMPUTED_ICP")
    t_res = t_test_deepim(tc, output_dir=str(tmp_path), device="cpu")
    _assert_tables(j_res, t_res, err_atol=1e-6)
    assert set(t_res["pose"]["sphere"]) == {0}


def test_vis_video_writes_videos(devkit, weights, tmp_path):
    """TEST.VIS_VIDEO: test_deepim writes video_cube.avi and
    video_sphere.avi, each num_pairs x test_iter frames (the devkit's 5
    pairs a class of the default 8, 4 iterations), and writes them again
    when a rerun serves pred_eval from results_pose.pkl."""
    _, tc = _cfgs(devkit, VIS_VIDEO=True, FAST_TEST=True)
    model = _fast_model(weights[1])
    for rerun in (False, True):
        res = t_test_deepim(tc, output_dir=str(tmp_path), batch_size=4, device="cpu", model=model)
        assert ("run" in res) != rerun  # the rerun read the cached poses
        for cls in CLASSES:
            path = tmp_path / f"video_{cls}.avi"
            idx = read_avi_index(str(path))
            assert (idx["frames"], idx["height"], idx["width"]) == (5 * 4, 2 * H, 2 * W)
            assert res["videos"][cls]["frames"] == 20
            path.unlink()


def test_unported_options_raise(devkit, tmp_path):
    """A checkpoint that is a directory (the JAX package's orbax format)
    raises, naming the converter that turns it into the port's file."""
    _, tc = _cfgs(devkit)
    os.makedirs(tmp_path / f"{PREFIX}_ckpt" / str(TEST_EPOCH))
    with pytest.raises(RuntimeError, match="orbax.*experiments/convert_orbax_checkpoint.py"):
        t_test_deepim(tc, output_dir=str(tmp_path), device="cpu")


def _write_yaml(path: Path, d: dict, indent: str = "") -> str:
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"{indent}{k}:")
            lines.append(_write_yaml(path, v, indent + "  "))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{indent}{k}: [{', '.join(str(x) for x in v)}]")
        elif isinstance(v, bool):
            lines.append(f"{indent}{k}: {'true' if v else 'false'}")
        elif isinstance(v, str):
            lines.append(f'{indent}{k}: "{v}"')
        else:
            lines.append(f"{indent}{k}: {v!r}")
    text = "\n".join(lines)
    if not indent:
        path.write_text(text + "\n")
    return text


@pytest.mark.parametrize("device", ["cpu", "default"])
def test_cli(devkit, tmp_path, device):
    """python -m deepim_tpu_torch.tools.test_net --cfg <yaml>: with --device
    cpu it runs to the end and writes the run directory; without it, on a
    host with no CUDA device, it raises instead of falling back."""
    if device == "default" and torch.cuda.is_available():
        pytest.skip("the no-CUDA refusal needs a host without a CUDA device")
    d = _cfg_dict(devkit, FAST_TEST=True)
    d["output_path"] = str(tmp_path / "out")
    cfg_file = tmp_path / "cfg.yaml"
    _write_yaml(cfg_file, d)
    cmd = [sys.executable, "-m", "deepim_tpu_torch.tools.test_net", "--cfg", str(cfg_file), "--batch-size", "4"]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    if device == "default":
        assert res.returncode != 0 and "torch.cuda.is_available() is False" in res.stderr
        return
    assert res.returncode == 0, res.stderr[-3000:]
    run_dir = tmp_path / "out" / PREFIX / "val_"
    assert (run_dir / "results_pose.pkl").exists() and (run_dir / "proj2d_curves_iter4.txt").exists()
    log = next(run_dir.glob("log_*.txt")).read_text()
    for table in ("5cm5deg", "ADD(-S) mean over 2 classes, iter 4", "Proj2D mean over 2 classes, iter 4"):
        assert table in log, table
