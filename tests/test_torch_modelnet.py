"""Parity of the port's unseen-object (ModelNet) evaluation and its
texture-sampling paths with the JAX package's on the CPU: data/modelnet.py,
the lit render_at_pose and refine, tools/test_net.test_modelnet through
test_deepim, refine and a training step with dataset.TEXTURE_SAMPLING, and
build_mesh_bank's textured dict.  The same numpy inputs and weights
(models/convert.py) go through both packages.  Tolerances are stated in
each test."""
import dataclasses
import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.tools.test_net as j_test_net  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import TrainIterConfig as JTIC  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.data.modelnet import ModelNetDB as JModelNetDB  # noqa: E402
from deepim_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from deepim_tpu.engine import LightParams as JLightParams  # noqa: E402
from deepim_tpu.engine import MeshBuffers as JMeshBuffers  # noqa: E402
from deepim_tpu.engine import Observation as JObservation  # noqa: E402
from deepim_tpu.engine import TrainBatch as JTrainBatch  # noqa: E402
from deepim_tpu.engine import TrainState as JTrainState  # noqa: E402
from deepim_tpu.engine import lr_schedule as jlr  # noqa: E402
from deepim_tpu.engine import make_train_step as j_make_train_step  # noqa: E402
from deepim_tpu.engine import refine as j_refine  # noqa: E402
from deepim_tpu.engine import render_at_pose as j_render_at_pose  # noqa: E402
from deepim_tpu.engine import train as jtrain  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.train_net import build_mesh_bank as j_build_mesh_bank  # noqa: E402
from deepim_tpu.tools.train_net import build_model as j_build_model  # noqa: E402
import deepim_tpu.models as j_models  # noqa: E402
from deepim_tpu_torch.config import Config, TrainConfig, TrainIterConfig, update_config_dict  # noqa: E402
from deepim_tpu_torch.data.modelnet import ModelNetDB, write_modelnet_lists  # noqa: E402
from deepim_tpu_torch.engine import (  # noqa: E402
    EngineConfig,
    LightParams,
    MeshBuffers,
    Observation,
    TrainBatch,
    TrainState,
    refine,
    render_at_pose,
)
from deepim_tpu_torch.engine import lr_schedule as tlr  # noqa: E402
from deepim_tpu_torch.engine import train as ttrain  # noqa: E402
from deepim_tpu_torch.engine.tester import bank_on_device  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM, state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.ops.masks import box_fill  # noqa: E402
from deepim_tpu_torch.render import mesh as t_mesh  # noqa: E402
from deepim_tpu_torch.render import standalone as t_standalone  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig, rasterize_textured  # noqa: E402
import deepim_tpu_torch.tools.test_net as t_test_net  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_deepim as t_test_deepim  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_modelnet as t_test_modelnet  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_mesh_bank, train_net  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
RASTER = dict(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128, chunk=16, znear=0.05, zfar=10.0)
N_POSES = 5


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """models.txt and poses.txt of two 'novel' meshes (a 0.09 m cube and
    an 80-face icosphere, vertex-coloured OBJs) and 5 random rotations at
    0.55 m, as tests/test_modelnet.py authors them."""
    root = tmp_path_factory.mktemp("modelnet")
    paths = []
    for name, m in {"c": t_mesh.make_test_cube(0.09), "s": t_mesh.make_icosphere(0.055, 1)}.items():
        os.makedirs(root / "models", exist_ok=True)
        paths.append(str(root / "models" / f"{name}.obj"))
        t_mesh.write_obj(paths[-1], m)
    rng = np.random.RandomState(5)
    poses = [(i % 2, np.concatenate([R.random(random_state=rng).as_matrix().astype(np.float32),
                                     np.array([[0.0], [0.0], [0.55]], np.float32)], 1))
             for i in range(N_POSES)]
    return write_modelnet_lists(str(root), paths, poses)


@functools.lru_cache(maxsize=None)
def _params(hw=(H, W)):
    """FAST_TEST-shaped JAX parameters (encoder and SE(3) heads, numpy)
    with a random nonzero translation head."""
    params = JFlowNet(pred_flow=False, pred_mask=False).init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    return params


def _port_model(hw=(H, W)):
    model = FlowNetDeepIM(input_hw=hw, pred_flow=False, pred_mask=False, device="cpu")
    model.load_state_dict(state_dict_from_flax(_params(hw)))
    return model.eval()


def _ecfgs(**kw):
    common = dict(height=H, width=W, update_mask="box_rendered", num_iters=2, **kw)
    return (JEngineConfig(raster=JRasterConfig(**RASTER), **common),
            EngineConfig(raster=RasterConfig(**RASTER), **common))


def test_modelnet_db_records_equal(lists):
    """ModelNetDB: the records (gt pose, perturbed initial pose, light
    position, intensity and brightness ratio) equal JAX's exactly, and so
    do the bank's arrays; the normals to 1e-6."""
    tdb, jdb = ModelNetDB(*lists), JModelNetDB(*lists)
    t_recs, j_recs = tdb.sample_records(), jdb.sample_records()
    assert len(t_recs) == len(j_recs) == N_POSES
    for a, b in zip(t_recs, j_recs):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
    tb, jb = tdb.mesh_bank(), jdb.mesh_bank()
    for key in ("vertices", "colors", "faces", "face_valid"):
        np.testing.assert_array_equal(getattr(tb, key), getattr(jb, key), err_msg=key)
    np.testing.assert_allclose(tb.normals, jb.normals, atol=1e-6, rtol=0)
    assert [r["model_index"] for r in t_recs] == [0, 1, 0, 1, 0]


def _lit_batch(lists):
    """Both packages' meshes, light, gt and initial poses for all records."""
    db = ModelNetDB(*lists)
    bank = db.mesh_bank()
    recs = db.sample_records()
    arrays = (bank.vertices, bank.colors, bank.faces, bank.face_valid, bank.normals)
    cls = np.asarray([r["model_index"] for r in recs])
    stack = {key: np.stack([r[key] for r in recs]) for key in recs[0] if key != "model_index"}
    jm = JMeshBuffers.gather(tuple(map(jnp.asarray, arrays)), jnp.asarray(cls))
    tm = MeshBuffers.gather(arrays, cls, device="cpu")
    jl = JLightParams(*(jnp.asarray(stack[k]) for k in ("light_position", "light_intensity", "brightness_ratio")))
    tl = LightParams(*(torch.from_numpy(stack[k]) for k in ("light_position", "light_intensity",
                                                            "brightness_ratio")))
    return jm, tm, jl, tl, stack


def test_lit_render_at_pose_equal(lists):
    """render_at_pose with the point light at the gt poses: masks exact,
    depth atol 1e-5, rgb atol 5e-3 after lighting; and the lit image is not
    the unlit one (the cached corner colours were not used)."""
    jm, tm, jl, tl, stack = _lit_batch(lists)
    j_ecfg, t_ecfg = _ecfgs()
    j_img, j_depth, j_mask = (np.asarray(x) for x in j_render_at_pose(
        jm, jnp.asarray(stack["pose_observed"]), jnp.asarray(K64), j_ecfg, jl))
    t_img, t_depth, t_mask = (x.numpy() for x in render_at_pose(
        tm, torch.from_numpy(stack["pose_observed"]), torch.from_numpy(K64), t_ecfg, tl, device="cpu"))
    assert j_mask.sum() > 500
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_allclose(t_depth, j_depth, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_img, j_img, atol=5e-3, rtol=0)
    unlit = render_at_pose(tm, torch.from_numpy(stack["pose_observed"]), torch.from_numpy(K64), t_ecfg,
                           device="cpu")[0].numpy()
    assert np.abs(unlit - t_img).max() > 20


def test_lit_refine_equal(lists):
    """A 2-iteration refine with lit re-renders, fp32 networks with the
    same weights on both sides: the poses of each iteration atol 1e-4."""
    jm, tm, jl, tl, stack = _lit_batch(lists)
    j_ecfg, t_ecfg = _ecfgs()
    img, _, mask = j_render_at_pose(jm, jnp.asarray(stack["pose_observed"]), jnp.asarray(K64), j_ecfg, jl)
    j_obs = JObservation(img, j_box_fill(mask), None, None, jnp.asarray(K64), light=jl)
    jmodel = JFlowNet(pred_flow=False, pred_mask=False)
    _, j_poses = jax.jit(lambda p, o, m, x: j_refine(p, jmodel, o, m, x, j_ecfg))(
        jax.tree_util.tree_map(jnp.asarray, _params()), j_obs, jm, jnp.asarray(stack["pose_rendered"]))
    t_img, _, t_mask = render_at_pose(tm, torch.from_numpy(stack["pose_observed"]), torch.from_numpy(K64),
                                      t_ecfg, tl, device="cpu")
    t_obs = Observation(t_img, box_fill(t_mask), None, None, torch.from_numpy(K64), light=tl)
    _, t_poses = refine(_port_model(), t_obs, tm, torch.from_numpy(stack["pose_rendered"]), t_ecfg, device="cpu")
    j_poses = np.asarray(j_poses)
    assert t_poses.shape == j_poses.shape == (2, N_POSES, 3, 4)
    np.testing.assert_allclose(t_poses.numpy(), j_poses, atol=1e-4, rtol=0)
    assert np.abs(j_poses[-1] - stack["pose_rendered"]).max() > 1e-3  # the refinement moved the poses


def _modelnet_cfgs(lists, out):
    d = {
        "SCALES": [H, W], "output_path": out,
        "dataset": {"dataset": "ModelNet_lit", "model_file": lists[0], "pose_file": lists[1],
                    "INTRINSIC_MATRIX": K64.flatten().tolist(), "ZNEAR": 0.05, "ZFAR": 10.0},
        "network": {"INPUT_MASK": True, "PRED_FLOW": False, "PRED_MASK": False},
        "TEST": {"test_iter": 2, "UPDATE_MASK": "box_rendered"},
    }
    return j_update(JConfig(), d), update_config_dict(Config(), d)


def _accuracies(res):
    return [int(np.sum((it["rot_err"] < 5) & (it["trans_err"] < 0.05))) for it in [res["init"]] + res["iters"]]


@functools.lru_cache(maxsize=None)
def _jax_modelnet(lists, fp32):
    """The JAX test_deepim on the ModelNet config with _params(), its
    networks fp32 or as it builds them (bf16)."""
    jc, _ = _modelnet_cfgs(lists, os.path.join(os.path.dirname(lists[0]), "out_jax"))
    with pytest.MonkeyPatch.context() as mp:
        if fp32:
            mp.setattr(j_test_net, "build_model", lambda cfg: j_build_model(cfg, dtype=jnp.float32))
            mp.setattr(j_models, "FlowNetDeepIM", lambda **kw: JFlowNet(**{**kw, "dtype": jnp.float32}))
        return j_test_net.test_deepim(jc, output_dir=os.path.dirname(lists[0]), params=_params(), batch_size=4)


def test_test_deepim_modelnet_equal(lists, tmp_path, monkeypatch):
    """test_deepim on a ModelNet_lit config (5 pairs in batches of 4, the
    last padded) in both packages, fp32 networks in both: per-iteration
    rotation errors atol 1e-2 deg and translation errors atol 1e-4 m, the
    initial errors exact, equal 5cm5deg accuracies, and the port's run
    dict."""
    j_res = _jax_modelnet(lists, True)
    _, tc = _modelnet_cfgs(lists, str(tmp_path))
    monkeypatch.setattr(t_test_net, "EVAL_DTYPE", torch.float32)
    t_res = t_test_deepim(tc, output_dir=str(tmp_path), batch_size=4, device="cpu", model=_port_model())
    for key in ("rot_err", "trans_err"):
        np.testing.assert_array_equal(t_res["init"][key], j_res["init"][key])
    assert len(t_res["iters"]) == len(j_res["iters"]) == 2
    for t_it, j_it in zip(t_res["iters"], j_res["iters"]):
        assert t_it["rot_err"].shape == (N_POSES,)
        np.testing.assert_allclose(t_it["rot_err"], j_it["rot_err"], atol=1e-2, rtol=0)
        np.testing.assert_allclose(t_it["trans_err"], j_it["trans_err"], atol=1e-4, rtol=0)
    assert _accuracies(t_res) == _accuracies(j_res)
    assert np.abs(t_res["iters"][-1]["trans_err"] - t_res["init"]["trans_err"]).max() > 1e-3
    run = t_res["run"]
    assert run["pairs"] == N_POSES and run["raster_dropped"] == 0
    for key in ("data_s", "net_s", "eval_s", "model_s"):
        assert run[key] > 0, key


def test_test_deepim_modelnet_bf16_default(lists, tmp_path):
    """test_deepim on the ModelNet config as both packages run it by
    default (bf16 networks, the zoom fp32 on the CPU): equal 5cm5deg
    accuracies at every iteration, and each iteration's mean rotation and
    translation errors within 3 times JAX's own bf16-vs-fp32 gap of JAX's
    bf16 means, plus 1e-3 deg / 1e-5 m (two bf16 networks round apart,
    tests/test_torch_bf16.py)."""
    j16, j32 = _jax_modelnet(lists, False), _jax_modelnet(lists, True)
    _, tc = _modelnet_cfgs(lists, str(tmp_path))
    assert t_test_net.EVAL_DTYPE == torch.bfloat16
    t_res = t_test_deepim(tc, output_dir=str(tmp_path), batch_size=4, device="cpu", model=_port_model())
    assert _accuracies(t_res) == _accuracies(j16)
    for t_it, a, b in zip(t_res["iters"], j16["iters"], j32["iters"]):
        for key, eps in (("rot_err", 1e-3), ("trans_err", 1e-5)):
            gap = abs(float(np.mean(a[key])) - float(np.mean(b[key])))
            assert abs(float(np.mean(t_it[key])) - float(np.mean(a[key]))) <= 3 * gap + eps, (key, gap)


# --- texture sampling ---------------------------------------------------------

TH, TW = 96, 128
K_TEX = np.array([[140.0, 0.0, 64.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]], np.float32)
TEX_RASTER = dict(height=TH, width=TW, tile_h=8, tile_w=64, max_faces_per_tile=256, chunk=16, znear=0.05,
                  zfar=10.0)


@functools.lru_cache(maxsize=None)
def _tex_scene():
    """Two textured uv spheres (1,024 and 576 faces) in one bank with
    keep_textures (textures 128x128 and 96x112, so one is padded), b=2 at
    gt poses 0.55 m away and perturbed initial poses; the observed images
    rendered by JAX with texture sampling."""
    meshes = [t_mesh.make_uv_sphere(0.05, 16, 32, t_mesh.smooth_texture(128, seed=11)),
              t_mesh.make_uv_sphere(0.06, 12, 24, t_mesh.smooth_texture(112, seed=12)[:96])]
    bank = t_mesh.MeshBank.from_meshes(meshes, pad_multiple=64, keep_textures=True).arrays()
    rng = np.random.RandomState(42)
    rot = R.from_euler("xyz", rng.uniform(-0.4, 0.4, (2, 3))).as_matrix().astype(np.float32)
    pose_gt = np.concatenate([rot, np.array([[[0.01], [-0.01], [0.55]]] * 2, np.float32)], 2)
    noise = R.from_euler("xyz", rng.uniform(-0.15, 0.15, (2, 3))).as_matrix().astype(np.float32)
    pose0 = pose_gt.copy()
    pose0[:, :, :3] = np.einsum("bij,bjk->bik", noise, pose_gt[:, :, :3])
    pose0[:, :, 3] += rng.uniform(-0.01, 0.01, (2, 3)).astype(np.float32)
    cls = np.array([0, 1], np.int32)
    common = dict(height=TH, width=TW, update_mask="box_gt", num_iters=2, texture_sampling=True)
    j_ecfg = JEngineConfig(raster=JRasterConfig(**TEX_RASTER), **common)
    t_ecfg = EngineConfig(raster=RasterConfig(**TEX_RASTER), **common)
    jm = JMeshBuffers.gather({k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(cls))
    img, depth, mask = (np.array(x) for x in j_render_at_pose(jm, jnp.asarray(pose_gt), jnp.asarray(K_TEX),
                                                              j_ecfg))
    return bank, cls, pose_gt, pose0, j_ecfg, t_ecfg, img, depth, mask


def test_texture_sampling_render_and_refine_equal():
    """render_at_pose with texture_sampling takes the textured render
    (equal to rasterize_textured, not the baked colours), matching JAX's:
    masks exact, depth 1e-5, rgb 5e-3; then a 2-iteration refine (the
    tests/test_texture_fidelity.py scene's kind, fp32 networks): poses of
    each iteration atol 1e-4."""
    bank, cls, pose_gt, pose0, j_ecfg, t_ecfg, img, depth, mask = _tex_scene()
    tm = MeshBuffers.gather(bank, cls, device="cpu")
    assert tm.uv is not None and tm.textures.shape == (2, 128, 128, 3)
    t_img, t_depth, t_mask = render_at_pose(tm, torch.from_numpy(pose_gt), torch.from_numpy(K_TEX), t_ecfg,
                                            device="cpu")
    np.testing.assert_array_equal(t_mask.numpy(), mask)
    np.testing.assert_allclose(t_depth.numpy(), depth, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_img.numpy(), img, atol=5e-3, rtol=0)
    direct = rasterize_textured(tm.vertices, tm.uv, tm.textures, tm.faces, tm.face_valid, torch.from_numpy(pose_gt),
                                torch.from_numpy(K_TEX), t_ecfg.raster, device="cpu")[0]
    assert torch.equal(direct.permute(0, 3, 1, 2), t_img)
    baked = render_at_pose(tm, torch.from_numpy(pose_gt), torch.from_numpy(K_TEX),
                           dataclasses.replace(t_ecfg, texture_sampling=False), device="cpu")[0]
    assert not torch.equal(baked, t_img)

    j_obs = JObservation(jnp.asarray(img), j_box_fill(jnp.asarray(mask)), jnp.asarray(mask), None,
                         jnp.asarray(K_TEX))
    jm = JMeshBuffers.gather({k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(cls))
    jmodel = JFlowNet(pred_flow=False, pred_mask=False)
    _, j_poses = jax.jit(lambda p, o, m, x: j_refine(p, jmodel, o, m, x, j_ecfg))(
        jax.tree_util.tree_map(jnp.asarray, _params((TH, TW))), j_obs, jm, jnp.asarray(pose0))
    t_obs = Observation(torch.from_numpy(img), box_fill(torch.from_numpy(mask)), torch.from_numpy(mask), None,
                        torch.from_numpy(K_TEX))
    _, t_poses = refine(_port_model((TH, TW)), t_obs, tm, torch.from_numpy(pose0), t_ecfg, device="cpu")
    np.testing.assert_allclose(t_poses.numpy(), np.asarray(j_poses), atol=1e-4, rtol=0)
    assert np.abs(np.asarray(j_poses)[-1] - pose0).max() > 1e-3


TICFG = dict(SE3_PM_LOSS=True, LW_PM=0.1, SE3_PM_LOSS_TYPE="L1", NUM_3D_SAMPLE=64, LW_FLOW=0.25, LW_MASK=0.03)


@functools.lru_cache(maxsize=None)
def _full_params():
    params = JFlowNet(pred_flow=True, pred_mask=True).init(jax.random.PRNGKey(0), jnp.zeros((1, TH, TW, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["trans"]["kernel"] = (np.random.RandomState(7).randn(256, 3) * 0.05).astype(np.float32)
    return params


def test_textured_train_step_equal():
    """One make_train_step of 2 inner iterations on the textured bank (its
    renders sampled per fragment through MeshBuffers.gather's uv and
    textures), the full network and the reference SGD recipe, against
    JAX's: tests/test_torch_train.py's tolerances (losses rtol 1e-4;
    parameters within 4 ulp of their magnitude plus 2% of the tensor's
    largest update; final pose atol 1e-5), every parameter updated."""
    bank, cls, pose_gt, pose0, j_ecfg, t_ecfg, img, depth, mask = _tex_scene()
    n_pts = 64
    arrs = dict(image_observed=img, mask_observed=np.asarray(j_box_fill(jnp.asarray(mask))),
                mask_gt_observed=mask, depth_gt_observed=depth[:, 0], pose_rendered=pose0, pose_observed=pose_gt,
                class_index=cls, points_model=bank["vertices"][cls][:, :n_pts],
                points_weights=np.ones((2, n_pts), np.float32), k=K_TEX)
    lr = 1e-3
    tx = jtrain.make_optimizer(JConfig(), jlr.warmup_multifactor_schedule(lr, (10000,)))
    jparams = jax.tree_util.tree_map(jnp.asarray, _full_params())
    jstate = JTrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(j_make_train_step(JFlowNet(pred_flow=True, pred_mask=True), tx, j_ecfg, JTIC(**TICFG), "viz"))
    jstate, j_m, j_pose = jstep(jstate, JTrainBatch(**{k: jnp.asarray(v) for k, v in arrs.items()}),
                                {k: jnp.asarray(v) for k, v in bank.items()})

    model = FlowNetDeepIM(input_hw=(TH, TW), device="cpu")
    model.load_state_dict(state_dict_from_flax(_full_params()))
    state = TrainState(model, ttrain.make_optimizer(model.parameters(), TrainConfig(),
                                                    tlr.warmup_multifactor_schedule(lr, (10000,))))
    step = ttrain.make_train_step(t_ecfg, TrainIterConfig(**TICFG), "viz", device="cpu")
    state, t_m, t_pose = step(state, TrainBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}),
                              bank_on_device(bank, torch.device("cpu")))
    for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
        assert np.isfinite(t_m[key].numpy()).all()
        np.testing.assert_allclose(t_m[key].numpy(), np.asarray(j_m[key]), rtol=1e-4, err_msg=key)
    assert not t_m["raster_dropped"].any()
    j_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    sd0 = state_dict_from_flax(_full_params())
    moved = 0
    for name, p in state.model.state_dict().items():
        ref, p0 = j_sd[name].numpy(), sd0[name].numpy()
        delta = float(np.abs(ref - p0).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(ref).max()))) + 2e-2 * delta
        np.testing.assert_allclose(p.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        moved += float(np.abs(p.numpy() - sd0[name].numpy()).max()) > 0
    assert moved == len(j_sd)
    np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-5, rtol=0)


def test_build_mesh_bank_texture_sampling(tmp_path):
    """build_mesh_bank with dataset.TEXTURE_SAMPLING returns the textured
    dict (vertices, colors, faces, face_valid, uv, textures), equal to the
    JAX package's; without it, the 4-tuple."""
    for i, cls in enumerate(("a", "b")):
        t_mesh.write_textured_obj(str(tmp_path / cls), t_mesh.make_uv_sphere(
            0.05, 4 + i, 8, t_mesh.smooth_texture(32 + 16 * i, seed=i)))
    d = {"dataset": {"model_dir": str(tmp_path), "class_name": ["a", "b"], "TEXTURE_SAMPLING": True}}
    got = build_mesh_bank(update_config_dict(Config(), d))
    want = j_build_mesh_bank(j_update(JConfig(), d))
    assert isinstance(got, dict) and set(got) == set(want) == {"vertices", "colors", "faces", "face_valid", "uv",
                                                                "textures"}
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    d["dataset"]["TEXTURE_SAMPLING"] = False
    assert len(build_mesh_bank(update_config_dict(Config(), d))) == 4


@pytest.mark.parametrize("entry", ["test_modelnet", "rasterize_textured", "standalone", "train_net"])
def test_new_entry_points_need_cuda_unless_cpu(entry, lists, tmp_path):
    """Without CUDA each new entry point raises unless given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    mesh = t_mesh.make_uv_sphere(0.05, 4, 8, t_mesh.smooth_texture(16))
    _, tc = _modelnet_cfgs(lists, str(tmp_path))
    calls = {
        "test_modelnet": lambda: t_test_modelnet(tc, _port_model()),
        "rasterize_textured": lambda: rasterize_textured(
            *(torch.from_numpy(x)[None] for x in (mesh.vertices, mesh.uv, mesh.texture, mesh.faces)),
            torch.ones(1, mesh.num_faces, dtype=torch.bool), torch.eye(3, 4)[None], torch.from_numpy(K64)),
        "standalone": lambda: t_standalone.render(mesh, (W, H), K64, np.eye(3), [0, 0, 0.5]),
        "train_net": lambda: train_net(update_config_dict(tc, {"dataset": {"TEXTURE_SAMPLING": True}})),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
