"""The orbax converter (experiments/convert_orbax_checkpoint.py): JAX-package
checkpoints, written by the JAX package's save_checkpoint, read into the
port on the CPU.

* test_deepim: a checkpoint of the full network on the 64x64 fixture
  devkit of tests/test_torch_eval.py, converted; both packages' drivers
  read their own checkpoint (fp32 networks on both sides) and give equal
  tables at that file's tolerance: pass counts and accuracies equal, error
  means 1e-4, everything else 1e-6.
* a resumed training step: a checkpoint with nonzero optimizer moments
  and counts (sgd with momentum; adam with clipping and apply_if_finite),
  converted; the port's optimizer state equals the checkpoint's bit for
  bit, and one train step of each package from its checkpoint gives
  parameters within tests/test_torch_train.py's one-step tolerance (4
  ulps of the tensor's magnitude plus 2% of its largest update).
"""
import importlib.util
import os
import sys
from pathlib import Path

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
from deepim_tpu.config import TrainIterConfig as JTIC  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from deepim_tpu.engine import MeshBuffers as JMeshBuffers  # noqa: E402
from deepim_tpu.engine import TrainBatch as JTrainBatch  # noqa: E402
from deepim_tpu.engine import make_train_step as j_make_train_step  # noqa: E402
from deepim_tpu.engine import render_at_pose as j_render_at_pose  # noqa: E402
from deepim_tpu.engine import lr_schedule as jlr  # noqa: E402
from deepim_tpu.engine import train as jtrain  # noqa: E402
from deepim_tpu.engine.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from deepim_tpu.engine.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.synth_data import generate_dataset as j_generate  # noqa: E402
from deepim_tpu.tools.train_net import build_model as j_build_model  # noqa: E402
from deepim_tpu_torch.config import Config, TrainIterConfig, update_config_dict  # noqa: E402
from deepim_tpu_torch.engine import EngineConfig, TrainBatch, TrainState  # noqa: E402
from deepim_tpu_torch.engine import lr_schedule as tlr  # noqa: E402
from deepim_tpu_torch.engine import train as ttrain  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import load_checkpoint, read_checkpoint  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
import deepim_tpu_torch.tools.test_net as t_test_net  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_deepim as t_test_deepim  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_model  # noqa: E402

_spec = importlib.util.spec_from_file_location("convert_orbax_checkpoint",
                                               REPO / "experiments" / "convert_orbax_checkpoint.py")
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
CLASSES = ("cube", "sphere")
PREFIX = "deepim_synth"
TEST_EPOCH = 2
RASTER = dict(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128, chunk=16, znear=0.05, zfar=10.0)


def _params():
    """The full JAX network's parameters (numpy) with a random nonzero
    translation head."""
    params = JFlowNet(pred_flow=True, pred_mask=True).init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    return params


def _cfgs(devkit_path="", **train):
    d = {
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
        "TRAIN": {"model_prefix": PREFIX, **train},
        "TEST": {"test_iter": 4, "test_epoch": TEST_EPOCH, "FAST_TEST": True},
    }
    return j_update(JConfig(), d), update_config_dict(Config(), d)


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    """tests/test_torch_eval.py's 64x64 devkit: a cube and an 80-face
    icosphere, 5 test pairs a class."""
    path = str(tmp_path_factory.mktemp("LM6d_refine_orbax"))
    j_generate(path, {"cube": j_mesh.make_test_cube(0.08), "sphere": j_mesh.make_icosphere(0.05, 1)}, K64,
               n_train=1, n_val=5, height=H, width=W, z_range=(0.45, 0.6), raster_cfg=JRasterConfig(**RASTER))
    return path


def _assert_tables(j_res, t_res):
    for table in ("pose", "add", "arp_2d"):
        assert set(j_res[table]) == set(t_res[table]), table
        for cls, by_iter in j_res[table].items():
            assert set(by_iter) == set(t_res[table][cls])
            for it, row in by_iter.items():
                trow = t_res[table][cls][it]
                assert set(row) == set(trow)
                for key, v in row.items():
                    if key == "errors":
                        assert abs(float(np.mean(v)) - float(np.mean(trow[key]))) <= 1e-4, (table, cls, it)
                    else:
                        np.testing.assert_allclose(np.asarray(trow[key], np.float64), np.asarray(v, np.float64),
                                                   atol=1e-6, rtol=0, err_msg=f"{table} {cls} {it} {key}")


def test_converted_checkpoint_test_deepim_equals_jax(devkit, tmp_path, monkeypatch):
    """The JAX driver reads the orbax checkpoint (checked: its
    load_checkpoint ran and returned), the port's reads the converted file
    through the command line; equal tables."""
    jc, tc = _cfgs(devkit)
    params = _params()
    tx = jtrain.make_optimizer(jc, jlr.warmup_multifactor_schedule(1e-4, (10000,)))
    out_j, out_t = tmp_path / "jax", tmp_path / "port"
    j_save_checkpoint(str(out_j / PREFIX), TEST_EPOCH, jtrain.TrainState(params, tx.init(params), np.int32(11)))

    loads = []

    def j_load(*args, **kw):
        loads.append(j_load_checkpoint(*args, **kw))
        return loads[-1]

    monkeypatch.setattr(j_test_net, "load_checkpoint", j_load)
    monkeypatch.setattr(j_test_net, "build_model", lambda cfg: j_build_model(cfg, dtype=jnp.float32))
    monkeypatch.setattr(j_models, "FlowNetDeepIM", lambda **kw: JFlowNet(**{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(t_test_net, "EVAL_DTYPE", torch.float32)
    j_res = j_test_net.test_deepim(jc, output_dir=str(out_j), batch_size=4)
    assert len(loads) == 1 and int(loads[0].step) == 11

    cfg_file = tmp_path / "cfg.yaml"  # the network and TRAIN settings the converter needs; the rest default
    cfg_file.write_text(f"SCALES: [{H}, {W}]\nnetwork:\n  INPUT_MASK: true\n  PRED_FLOW: true\n  PRED_MASK: true\n"
                        f"TRAIN:\n  model_prefix: \"{PREFIX}\"\n")
    path = converter.main(["--cfg", str(cfg_file), "--prefix", str(out_j / PREFIX), "--epoch", str(TEST_EPOCH),
                           "--out-prefix", str(out_t / PREFIX)])
    assert path == str(out_t / f"{PREFIX}_ckpt" / str(TEST_EPOCH)) and os.path.isfile(path)
    payload = read_checkpoint(str(out_t / PREFIX), TEST_EPOCH)
    assert payload["step"] == 11 and payload["optimizer"]["count"] == 0
    sd = state_dict_from_flax(params)
    assert set(payload["model"]) == set(sd)
    for name, v in sd.items():
        assert torch.equal(payload["model"][name], v), name
    t_res = t_test_deepim(tc, output_dir=str(out_t), batch_size=4, device="cpu")
    _assert_tables(j_res, t_res)
    with pytest.raises(ValueError, match="must differ"):
        converter.convert(tc, str(out_j / PREFIX), TEST_EPOCH, str(out_j / PREFIX))


# --- a resumed training step --------------------------------------------------

TICFG = dict(SE3_PM_LOSS=True, LW_PM=0.1, SE3_PM_LOSS_TYPE="L1", NUM_3D_SAMPLE=64, LW_FLOW=0.25, LW_MASK=0.03)
N_PTS = 64
OPTIMIZERS = {
    "sgd": dict(optimizer="sgd", momentum=0.975, wd=0.0005, grad_clip=0.0, skip_nonfinite=False, lr=1e-3),
    "adam": dict(optimizer="adam", wd=0.0005, grad_clip=1.0, skip_nonfinite=True, lr=1e-4),
}


def _scene():
    """A batch of 2 (the cube and the 80-face icosphere) at 64x64, gt
    rendered by JAX, start poses perturbed."""
    from scipy.spatial.transform import Rotation as R

    b = 2
    rng = np.random.RandomState(42)
    rot = R.from_euler("xyz", rng.uniform(-0.4, 0.4, (b, 3))).as_matrix().astype(np.float32)
    pose_gt = np.concatenate([rot, np.zeros((b, 3, 1), np.float32)], 2)
    pose_gt[:, :, 3] = [[0.01, -0.01, 0.55], [-0.01, 0.02, 0.5]]
    pose0 = pose_gt.copy()
    pose0[:, :, :3] = np.einsum("bij,bjk->bik", R.from_euler("xyz", rng.uniform(-0.15, 0.15, (b, 3))).as_matrix()
                                .astype(np.float32), rot)
    pose0[:, :, 3] += rng.uniform(-0.01, 0.01, (b, 3)).astype(np.float32)
    common = dict(height=H, width=W, update_mask="box_gt", num_iters=2, normalize_flow=20.0)
    j_ecfg = JEngineConfig(raster=JRasterConfig(**RASTER, use_pallas=False), **common)
    t_ecfg = EngineConfig(raster=RasterConfig(**RASTER), **common)
    bank = j_mesh.MeshBank.from_meshes([j_mesh.make_test_cube(0.08), j_mesh.make_icosphere(0.05, 1)],
                                       pad_multiple=64)
    bank_np = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
    cls = np.arange(b).astype(np.int32)
    jm = JMeshBuffers.gather(tuple(map(jnp.asarray, bank_np)), jnp.asarray(cls))
    img, depth, mask = (np.asarray(x) for x in j_render_at_pose(jm, jnp.asarray(pose_gt), jnp.asarray(K64), j_ecfg))
    arrs = dict(image_observed=img, mask_observed=np.asarray(j_box_fill(jnp.asarray(mask))), mask_gt_observed=mask,
                depth_gt_observed=depth[:, 0], pose_rendered=pose0, pose_observed=pose_gt, class_index=cls,
                points_model=bank.vertices[cls][:, :N_PTS], points_weights=np.ones((b, N_PTS), np.float32), k=K64)
    return j_ecfg, t_ecfg, bank_np, arrs


def _moments(opt_state, rng):
    """opt_state with every moment random (second moments positive) and
    every integer count 7."""
    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return x
        if x.ndim == 0:
            return np.asarray(7, x.dtype)
        return (np.abs(rng.randn(*x.shape)) * 1e-2).astype(x.dtype)

    return jax.tree_util.tree_map(fill, opt_state)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_converted_checkpoint_resumes_like_jax(tmp_path, name):
    jc, tc = _cfgs(**OPTIMIZERS[name])
    lr = OPTIMIZERS[name]["lr"]
    params = _params()
    tx = jtrain.make_optimizer(jc, jlr.warmup_multifactor_schedule(lr, (10000,)))
    opt_state = _moments(tx.init(params), np.random.RandomState(3))
    j_save_checkpoint(str(tmp_path / "jax"), 1, jtrain.TrainState(params, opt_state, np.int32(7)))
    converter.convert(tc, str(tmp_path / "jax"), 1, str(tmp_path / "port"))

    model = build_model(tc, dtype=torch.float32, device="cpu")
    opt = ttrain.make_optimizer(model.parameters(), tc.TRAIN, tlr.warmup_multifactor_schedule(lr, (10000,)))
    state = load_checkpoint(str(tmp_path / "port"), 1, TrainState(model, opt))
    assert (state.step, opt.count, opt.notfinite_count) == (7, 7, 7 if name == "adam" else 0)
    if name == "sgd":  # (add_decayed_weights, (trace, schedule))
        moments = [("momentum_buffer", opt_state[1][0].trace)]
    else:  # apply_if_finite((clip, (scale_by_adam, add_decayed_weights, schedule)))
        adam = opt_state.inner_state[1][0]
        moments = [("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)]
    for key, tree in moments:
        ref = state_dict_from_flax(tree)
        for pname, p in model.named_parameters():
            assert torch.equal(opt.inner.state[p][key], ref[pname]), (key, pname)
    if name == "adam":
        assert all(float(opt.inner.state[p]["step"]) == 7.0 for p in model.parameters())
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}

    j_ecfg, t_ecfg, bank_np, arrs = _scene()
    jstep = jax.jit(j_make_train_step(JFlowNet(pred_flow=True, pred_mask=True), tx, j_ecfg, JTIC(**TICFG), "viz"))
    template = jtrain.TrainState(jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), jnp.zeros((), jnp.int32))
    restored = j_load_checkpoint(str(tmp_path / "jax"), 1, template)
    jstate, _, _ = jstep(jax.tree_util.tree_map(jnp.asarray, restored),
                         JTrainBatch(**{k: jnp.asarray(v) for k, v in arrs.items()}),
                         tuple(map(jnp.asarray, bank_np)))
    step = ttrain.make_train_step(t_ecfg, TrainIterConfig(**TICFG), "viz", device="cpu")
    state, _, _ = step(state, TrainBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}), bank_np)
    assert state.step == int(jstate.step) == 9 and opt.count == 9
    j_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    moved = 0
    for pname, p in state.model.state_dict().items():
        ref, p0 = j_sd[pname].numpy(), sd0[pname].numpy()
        delta = float(np.abs(ref - p0).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(ref).max()))) + 2e-2 * delta
        np.testing.assert_allclose(p.numpy(), ref, atol=atol, rtol=0, err_msg=pname)
        moved += delta > 0
    assert moved == len(j_sd)


def test_converter_names_what_it_cannot_map(tmp_path):
    """A checkpoint whose optimizer state does not fit the config raises,
    naming the part: an adam checkpoint for an sgd config, apply_if_finite
    against skip_nonfinite off, a state part the port holds none of."""
    params = _params()
    jc_adam, _ = _cfgs(**OPTIMIZERS["adam"])
    tx = jtrain.make_optimizer(jc_adam, jlr.warmup_multifactor_schedule(1e-4, (10000,)))
    j_save_checkpoint(str(tmp_path / "jax"), 1, jtrain.TrainState(params, tx.init(params), np.int32(0)))
    _, tc_sgd = _cfgs(**OPTIMIZERS["sgd"])
    with pytest.raises(ValueError, match="no optax trace"):
        converter.convert(tc_sgd, str(tmp_path / "jax"), 1, str(tmp_path / "port"))
    _, tc_adam = _cfgs(**{**OPTIMIZERS["adam"], "skip_nonfinite": False})
    with pytest.raises(ValueError, match="notfinite_count"):
        converter.convert(tc_adam, str(tmp_path / "jax"), 1, str(tmp_path / "port"))
    with pytest.raises(ValueError, match=r"opt_state\[0\].*none the port's optimizer holds"):
        converter.optimizer_parts([{"velocity": np.zeros(3)}])
