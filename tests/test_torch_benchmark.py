"""Parity of the port's synthetic accuracy benchmark path
(render/mesh.py:make_benchmark_classes, tools/synth_data.py:
generate_occlusion_dataset, tools/benchmark_multiclass.py and
tools/benchmark_occlusion.py) with the JAX package's and its runners
(experiments/benchmark_multiclass.py, experiments/benchmark_occlusion.py)
on the CPU.

Tolerances: the benchmark meshes bit for bit; the occlusion devkit's
listing, text files and label images exact, pose files to 1e-6, depth
exact, colour exact for the benchmark classes and within 1 level for the
JAX test's cube (its faces' 255 sits on the uint8 truncation edge, where
the renders agree to rgb 5e-3, the raster tolerance); each runner's Config
field for field; the init-pose rows exact on one devkit; one tiny run of
each runner in both packages (64x64, 2 classes at subdiv 1, 4 pairs a
class, 1 epoch, fp32 networks from the same initial weights): every
step's losses to rtol 1e-3 (the fine-tune's viz_visible flow loss 5e-2,
see the test), the printed tables' accuracies equal, AUCs to 0.05 points
and flow EPE to 2e-3 px."""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import shutil
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
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.engine.checkpoint as j_checkpoint  # noqa: E402
import deepim_tpu.tools.test_net as j_test_net  # noqa: E402
import deepim_tpu.tools.train_net as j_train_net  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.data import pairdb as j_pairdb  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.synth_data import generate_occlusion_dataset as j_generate_occ  # noqa: E402
from deepim_tpu_torch.data import pairdb as t_pairdb  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
from deepim_tpu_torch.tools import benchmark_multiclass as t_bm  # noqa: E402
from deepim_tpu_torch.tools import benchmark_occlusion as t_bo  # noqa: E402
from deepim_tpu_torch.tools import test_net as t_test_net  # noqa: E402
from deepim_tpu_torch.tools import train_net as t_train_net  # noqa: E402
from deepim_tpu_torch.tools.synth_data import generate_occlusion_dataset as t_generate_occ  # noqa: E402
from deepim_tpu_torch.utils.logger import logger as t_logger  # noqa: E402
from deepim_tpu_torch.utils.png import read_png  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
# The JAX occlusion test's raster settings (tests/test_occlusion.py:21-35).
RASTER = dict(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128, chunk=16, znear=0.05, zfar=10.0)
OCC = dict(n_scenes=6, n_train=2, height=H, width=W, z_range=(0.45, 0.6), lateral_spread=0.02)
MESH_SETS = {
    "benchmark": lambda mod: mod.make_benchmark_classes(2, subdiv=1),
    "cube_sphere": lambda mod: {"cube": mod.make_test_cube(0.08), "sphere": mod.make_icosphere(0.05, 1)},
}
_J_BUILD_MODEL = j_train_net.build_model
_T_BUILD_MODEL = t_train_net.build_model


def _jax_runner(name: str):
    """experiments/<name>.py as a module (a script, not a package module)."""
    spec = importlib.util.spec_from_file_location(f"j_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_BM = _jax_runner("benchmark_multiclass")
J_BO = _jax_runner("benchmark_occlusion")


# -- meshes ------------------------------------------------------------------------

@pytest.mark.parametrize("subdiv", [1, 2, 3])
def test_benchmark_classes_bit_equal(subdiv):
    """make_benchmark_classes(13) equals the JAX package's bit for bit:
    names, vertices, faces and colours with their dtypes."""
    j, t = j_mesh.make_benchmark_classes(13, subdiv=subdiv), t_mesh.make_benchmark_classes(13, subdiv=subdiv)
    assert list(t) == list(j) == [f"obj{i:02d}" for i in range(13)]
    for name in j:
        assert t[name].num_faces == 20 * 4 ** subdiv
        for field in ("vertices", "faces", "colors"):
            a, b = getattr(j[name], field), getattr(t[name], field)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (name, field)
    m = t_mesh.make_colored_mesh(t["obj00"].vertices.astype(np.float64), t["obj00"].faces.astype(np.int64))
    jm = j_mesh.make_colored_mesh(j["obj00"].vertices.astype(np.float64), j["obj00"].faces.astype(np.int64))
    for field in ("vertices", "faces", "colors"):
        a, b = getattr(jm, field), getattr(m, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


# -- the occlusion devkit ------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(MESH_SETS))
def occ_devkits(request, tmp_path_factory):
    """The occlusion devkit written by each package from the same meshes
    (the port's on the CPU)."""
    root = tmp_path_factory.mktemp(f"occ_{request.param}")
    meshes = MESH_SETS[request.param]
    j_generate_occ(str(root / "jax"), meshes(j_mesh), K64, raster_cfg=JRasterConfig(**RASTER), **OCC)
    t_generate_occ(str(root / "port"), meshes(t_mesh), K64, raster_cfg=RasterConfig(**RASTER), device="cpu",
                   **OCC)
    return request.param, str(root / "jax"), str(root / "port")


def _listing(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def test_occlusion_devkit_equals_jax(occ_devkits):
    """Same files; lists, models and info text equal; pose files to 1e-6;
    labels and depth equal after decoding, colour equal for the benchmark
    classes and within 1 level with equal hit masks for the cube and
    sphere; at least one scene in which one object hides part of another."""
    mesh_set, j_root, t_root = occ_devkits
    files = _listing(j_root)
    assert _listing(t_root) == files
    assert len([f for f in files if f.startswith("data/observed/scenes/")]) == 3 * OCC["n_scenes"]
    n_diff = occluded = 0
    for rel in files:
        a_path, b_path = os.path.join(j_root, rel), os.path.join(t_root, rel)
        if rel.endswith("-pose.txt"):
            np.testing.assert_allclose(j_pairdb.load_pose_file(b_path), j_pairdb.load_pose_file(a_path), rtol=0,
                                       atol=1e-6, err_msg=rel)
        elif not rel.endswith(".png"):
            assert Path(b_path).read_text() == Path(a_path).read_text(), rel
        else:
            a = cv2.imread(a_path, cv2.IMREAD_UNCHANGED).astype(np.int64)
            b = read_png(b_path).astype(np.int64)
            if a.ndim == 3:
                a = a[:, :, ::-1]
            assert a.shape == b.shape, rel
            if rel.endswith("-color.png") and mesh_set == "cube_sphere":
                np.testing.assert_array_equal(b.any(-1), a.any(-1), err_msg=rel)
                assert np.abs(b - a).max() <= 1, rel
                n_diff += int((b != a).any())
            else:
                np.testing.assert_array_equal(b, a, err_msg=rel)
            if rel.endswith("-label.png"):
                idx = os.path.basename(rel).split("-")[0]
                for ci, cls in enumerate(sorted(MESH_SETS[mesh_set](t_mesh)), start=1):
                    alone = read_png(os.path.join(t_root, "data", "gt_observed", cls, f"{idx}-depth.png"))
                    occluded += int(0 < (b == ci).sum() < (alone > 0).sum())
    assert occluded >= 1
    # The cube's colours differ by a level in some files: the tolerance is needed.
    assert (n_diff > 0) == (mesh_set == "cube_sphere")


@pytest.mark.parametrize("image_set", ["val", "train"])
def test_jax_pairdb_reads_port_occlusion_devkit(occ_devkits, image_set):
    """The JAX PairDB reads the port's devkit into the records it reads
    from its own (mask_idx: the class id in the scene's label, sorted
    class order), and so does the port's."""
    mesh_set, j_root, t_root = occ_devkits
    n = OCC["n_scenes"] - OCC["n_train"] if image_set == "val" else OCC["n_train"]
    for ci, cls in enumerate(sorted(MESH_SETS[mesh_set](t_mesh)), start=1):
        recs = {}
        for name, mod, root in (("jax", j_pairdb, j_root), ("port", j_pairdb, t_root), ("port_db", t_pairdb, t_root)):
            _, recs[name] = mod.load_gt_pairdb(JConfig(), "LM6D_REFINE", f"{image_set}_{cls}", cls, root, root)
        assert len(recs["jax"]) == n
        for a, b, c in zip(recs["jax"], recs["port"], recs["port_db"]):
            assert a["mask_idx"] == b["mask_idx"] == c["mask_idx"] == ci
            assert "scenes/" in b["image_observed"]
            for key in ("pose_observed", "pose_rendered"):
                np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-6)
                np.testing.assert_array_equal(c[key], b[key])
            assert os.path.relpath(b["image_observed"], t_root) == os.path.relpath(a["image_observed"], j_root)


# -- the runners' configs ----------------------------------------------------------------

class _Stop(Exception):
    pass


def _capture(mp, owner, name: str, store: dict, key: str = "cfg"):
    """Replace owner.name by a function that keeps its first argument and stops the run."""
    def stop(cfg, *args, **kwargs):
        store[key] = cfg
        raise _Stop
    mp.setattr(owner, name, stop)


# tools/a1_protocol.sh's chunks, as experiments/run_r5_chip_queue5.sh runs them.
A1_480 = ["--size", "480", "--width", "640", "--train-iter-size", "4", "--classes", "13", "--batch", "16", "--lr",
          "1e-4", "--n-train", "128"]
MULTICLASS_FLAGS = {
    "defaults": [],
    "480x640": ["--size", "480", "--width", "640", "--epochs", "8", "--train-iter-size", "4", "--lr", "1e-4",
                "--classes", "3", "--lw-flow", "0", "--batch", "16", "--resume-epoch", "4"],
    "a1_256_base_to_30": ["--size", "256", "--train-iter-size", "4", "--epochs", "30", "--classes", "13", "--lr",
                          "2e-4", "--resume-epoch", "15", "--train-only"],
    "a1_480x640_seeded_0to4": [*A1_480, "--epochs", "4", "--seed-convs", "base/run/bench13", "--seed-epoch", "30",
                               "--train-only"],
    "a1_480x640_4to8": [*A1_480, "--epochs", "8", "--resume-epoch", "4", "--train-only"],
}
OCCLUSION_FLAGS = {
    "fine-tune": ["--epochs", "30"],
    "a1_queue5": ["--size", "256", "--epochs", "30", "--train-scenes", "256", "--finetune-epochs", "30"],
    "box_gt": ["--size", "256", "--epochs", "30", "--finetune-epochs", "8", "--train-iter-size", "2",
               "--ft-mask", "box_gt", "--resume-epoch", "34", "--batch", "16", "--train-scenes", "64"],
    "zero-shot": ["--train-scenes", "0", "--n-scenes", "16", "--classes", "4"],
}


@pytest.mark.parametrize("flags", sorted(MULTICLASS_FLAGS))
def test_multiclass_config_equals_jax(flags, tmp_path):
    """benchmark_multiclass hands train_net a Config equal to the JAX
    runner's, field for field, for the same flags (an existing devkit, so
    neither generates one)."""
    argv = MULTICLASS_FLAGS[flags]
    out = tmp_path / "devkit"
    (out / "image_set").mkdir(parents=True)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        if "--seed-convs" in argv:
            # The seeding itself is held to JAX's in tests/test_torch_protocol.py.
            mp.setattr(j_train_net, "build_model", lambda cfg: (None, {}))
            mp.setattr(j_checkpoint, "load_checkpoint", lambda prefix, epoch, state: state)
            mp.setattr(t_bm, "build_model", lambda cfg, device: torch.nn.Module())
            mp.setattr(t_bm, "read_checkpoint", lambda prefix, epoch: {"model": {}})
        _capture(mp, j_train_net, "train_net", got, "jax")
        mp.setattr(sys, "argv", ["benchmark_multiclass.py", *argv, "--out", str(out)])
        with pytest.raises(_Stop):
            J_BM.main()
        _capture(mp, t_bm, "train_net", got, "port")
        with pytest.raises(_Stop):
            t_bm.main([*argv, "--out", str(out), "--device", "cpu"])
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["jax"])
    assert got["port"].TRAIN.RESUME == ("--resume-epoch" in argv)


@pytest.mark.parametrize("flags", sorted(OCCLUSION_FLAGS))
def test_occlusion_config_equals_jax(flags, tmp_path):
    """benchmark_occlusion hands train_net the JAX runner's fine-tune
    Config (or, with --train-scenes 0, test_deepim its test Config), field
    for field, for the same flags; the devkits are keyed the same way
    under the temp directory."""
    argv = OCCLUSION_FLAGS[flags]
    args = t_bo.parse_args(argv)
    occ = Path(t_bm.default_devkit(args.classes, args.size, args.subdiv)).name + \
        f"_occ{args.train_scenes}_{args.n_scenes}"
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(tmp_path))
        (tmp_path / occ / "image_set").mkdir(parents=True)
        (tmp_path / occ / "run" / "occ13_ckpt" / str(args.epochs)).mkdir(parents=True)
        mp.setattr(j_train_net, "build_model", lambda cfg: (None, None))
        mp.setattr(j_checkpoint, "load_checkpoint", lambda prefix, epoch, state: state)
        _capture(mp, j_train_net, "train_net", got, "jax")
        _capture(mp, j_test_net, "test_deepim", got, "jax")
        mp.setattr(sys, "argv", ["benchmark_occlusion.py", *argv])
        with pytest.raises(_Stop):
            J_BO.main()
        shutil.rmtree(tmp_path / occ / "run")
        (tmp_path / occ / "run").mkdir()
        if args.train_scenes:
            seed = t_bo.checkpoint_path(os.path.join(tmp_path, occ[: occ.index("_occ")], "run", t_bm.PREFIX),
                                        args.epochs)
            os.makedirs(os.path.dirname(seed))
            Path(seed).write_bytes(b"seed")
        mp.setattr(t_bo, "build_model", lambda cfg, device: None)
        mp.setattr(t_bo, "load_checkpoint", lambda prefix, epoch, state: state)
        _capture(mp, t_bo, "train_net", got, "port")
        _capture(mp, t_bo, "fresh_results", got, "port")
        with pytest.raises(_Stop):
            t_bo.main([*argv, "--device", "cpu"])
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["jax"])
    if args.train_scenes:
        copied = t_bo.checkpoint_path(os.path.join(tmp_path, occ, "run", t_bo.FT_PREFIX), args.epochs)
        assert Path(copied).read_bytes() == b"seed"
        assert got["port"].TRAIN.FLOW_WEIGHT_TYPE == "viz_visible"


# -- the runners end to end --------------------------------------------------------------

E2E_MULTICLASS = ["--size", "64", "--classes", "2", "--subdiv", "1", "--n-train", "4", "--n-val", "4",
                  "--epochs", "1", "--batch", "4"]
E2E_OCCLUSION = ["--size", "64", "--classes", "2", "--subdiv", "1", "--epochs", "1", "--n-scenes", "4",
                 "--train-scenes", "4", "--finetune-epochs", "1", "--batch", "4"]


def _printed(text: str, tag: str) -> dict:
    line, = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both runners in each package, fp32 networks from the JAX package's
    initial weights (each build_model and eval dtype patched: both build
    bf16 by default); the port on the CPU.  Returns each package's printed
    tables and the port's returned figures."""
    root = tmp_path_factory.mktemp("bench_e2e")
    runs = {}
    before = list(t_logger.handlers)
    drawn, heard = [], []

    class Speedo:
        """The JAX driver's Speedometer, hearing every step."""

        def __init__(self, batch_size, frequent=20):
            self.frequent = 1

        def __call__(self, epoch, nbatch, metrics=None):
            heard.append(dict(metrics))

    def jax_model(cfg):
        model, params = _J_BUILD_MODEL(cfg, dtype=jnp.float32)
        drawn.append(params)
        return model, params

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_train_net, "build_model", jax_model)
        mp.setattr(j_test_net, "build_model", jax_model)
        mp.setattr(j_train_net, "Speedometer", Speedo)
        # One device, as the port's run (the tests' JAX has 8 virtual CPU devices).
        mp.setattr(j_train_net, "train_net", functools.partial(j_train_net.train_net, n_devices=1))
        mp.setattr(tempfile, "tempdir", str(root / "jax"))
        os.makedirs(root / "jax")
        outputs = []
        for mod, argv in ((J_BM, E2E_MULTICLASS), (J_BO, E2E_OCCLUSION)):
            mp.setattr(sys, "argv", ["runner.py", *argv])
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                mod.main()
            outputs.append(buf.getvalue())
        runs["jax"] = {"multiclass": _printed(outputs[0], "BENCH13_JSON"),
                       "occlusion": _printed(outputs[1], "BENCH_OCC_JSON"),
                       "steps": {"multiclass": heard[:2], "occlusion": heard[2:]}}
        # The multiclass train_net's draw: the weights both packages start from.
        init = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, drawn[0]))

        def port_model(cfg, dtype=torch.bfloat16, device="cuda"):
            model = _T_BUILD_MODEL(cfg, dtype=torch.float32, device=device)
            model.load_state_dict(init)
            return model

        mp.setattr(t_train_net, "build_model", port_model)
        mp.setattr(t_test_net, "EVAL_DTYPE", torch.float32)
        out = str(root / "port" / "devkit")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            multiclass = t_bm.main([*E2E_MULTICLASS, "--out", out, "--device", "cpu"])
            occlusion = t_bo.main([*E2E_OCCLUSION, "--out", out, "--device", "cpu"])
        runs["port"] = {"multiclass": _printed(buf.getvalue(), "BENCH13_JSON"),
                        "occlusion": _printed(buf.getvalue(), "BENCH_OCC_JSON"),
                        "returned": {"multiclass": multiclass, "occlusion": occlusion}}
    for h in [h for h in t_logger.handlers if h not in before]:
        t_logger.removeHandler(h)
        h.close()
    runs["jax_devkit"] = str(root / "jax" / "bench13_2c_64_1")
    runs["port_devkit"] = out
    return runs


def _assert_rows_close(a: dict, b: dict, what: str):
    """Accuracies equal, AUCs to 0.05 points, the EPE (printed to 3
    decimals) to 2e-3 px."""
    assert set(a) == set(b), what
    for key, v in a.items():
        tol = 2e-3 if key.startswith("EPE") else 0.05 if key.endswith("auc") else 0.0
        assert abs(b[key] - v) <= tol, (what, key, v, b[key])


@pytest.mark.parametrize("runner", ["multiclass", "occlusion"])
def test_runner_tables_match_jax(e2e, runner):
    """Each runner's training losses and printed table (init row and 4
    iterations) against the JAX runner's on the same flags.  Every step's
    losses at each inner iteration to rtol 1e-3 (the training driver's
    rule, tests/test_torch_train_driver.py; measured 3e-6), except the
    fine-tune's flow loss, to 5e-2: its viz_visible weights look the
    object's label up at the flow target's nearest pixel
    (ops/flow.gather_at_flow_target), and one target a rounding away from
    .5 flips a pixel's weight (measured once in the run: 2.1e-2 at step 2,
    inner iteration 2; the next iteration's losses agree to 2e-5 again).
    The tables by _assert_rows_close (measured: equal as printed).  At
    64x64 the init noise leaves ADD(-S)<0.1d at 0 and Proj2D@5px at 100
    in both, so the losses, the flow EPE and the AUCs carry the
    comparison.  The port's returned table is the printed one, its run
    dropped no pair and each epoch's losses are finite."""
    j, t = e2e["jax"][runner], e2e["port"][runner]
    returned = e2e["port"]["returned"][runner]
    e, = returned["epochs"]
    assert e["nonfinite_losses"] == e["raster_dropped"] == 0
    heard = e2e["jax"]["steps"][runner]
    n_inner = e["metrics"]["total"].shape[1]
    assert len(heard) == e["metrics"]["total"].shape[0] == 2 and n_inner == (2 if runner == "multiclass" else 4)
    for step, jm in enumerate(heard):
        for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
            rtol = 5e-2 if key == "flow_loss" and runner == "occlusion" else 1e-3
            for it in range(n_inner):
                np.testing.assert_allclose(e["metrics"][key][step, it], jm[f"{key}/iter{it}"], rtol=rtol,
                                           err_msg=f"{runner} step {step} {key} iter {it}")
    assert t["init"] == j["init"]
    assert len(t["iters"]) == len(j["iters"]) == 4
    for it, (a, b) in enumerate(zip(j["iters"], t["iters"])):
        _assert_rows_close(a, b, f"{runner} iter {it + 1}")
    assert json.loads(json.dumps(returned["table"])) == t
    assert returned["run"]["pairs"] == 8 and returned["run"]["raster_dropped"] == 0
    assert returned["generation"]["seconds"] > 0


def test_init_rows_equal_on_one_devkit(e2e):
    """The port's init-pose rows on the JAX runner's devkit are the ones
    the JAX runner printed, exactly; and the two runners' devkits hold the
    same pose files, so the port's own rows are equal too."""
    args = t_bm.parse_args(E2E_MULTICLASS)
    classes = ["obj00", "obj01"]
    k = t_bm.benchmark_k(H, W)
    for devkit in (e2e["jax_devkit"], e2e["port_devkit"]):
        rows = t_bm.init_pose_rows(t_bm.benchmark_config(args, devkit, classes, k), classes, k)
        assert {key: float(np.mean(v)) for key, v in rows.items()} == e2e["jax"]["multiclass"]["init"]
    for rel in _listing(e2e["jax_devkit"]):
        if rel.endswith("-pose.txt"):
            assert (Path(e2e["port_devkit"]) / rel).read_text() == (Path(e2e["jax_devkit"]) / rel).read_text()
