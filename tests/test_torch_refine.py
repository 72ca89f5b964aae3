"""Parity of the port's refinement engine (deepim_tpu_torch.engine) with
the JAX package's on the CPU: the 64x64 dryrun scene (dense raster path)
and a 96x128 ico4 scene (CSR path), with the same weights in both
frameworks through the weight bridge; plus the package's import hygiene."""
import functools
import os
import subprocess
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

from __graft_entry__ import _build_scene  # noqa: E402
from deepim_tpu.engine import Observation as JObservation  # noqa: E402
from deepim_tpu.engine import refine as j_refine  # noqa: E402
from deepim_tpu.engine import refine_step as j_refine_step  # noqa: E402
from deepim_tpu.engine.refine import render_at_pose as j_render_at_pose  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu_torch.engine import refine as t_refine  # noqa: E402
from deepim_tpu_torch.engine import refine_step as t_refine_step  # noqa: E402
from deepim_tpu_torch.engine import render_at_pose as t_render_at_pose  # noqa: E402
from deepim_tpu_torch.engine.refine import Observation as TObservation  # noqa: E402
from deepim_tpu_torch.engine.scene import build_scene  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM as TFlowNet  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402

torch.set_num_threads(2)

K64 = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
K96 = np.array([[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]], np.float32)


@functools.lru_cache(maxsize=None)
def _weights(hw):
    """Full-model JAX params with a random nonzero trans head (numpy), and
    the port's model loaded from them."""
    params = JFlowNet(pred_flow=True, pred_mask=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    model = TFlowNet(input_hw=hw, device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return params, model.eval()


@functools.lru_cache(maxsize=None)
def _scenes(update_mask):
    j = _build_scene(2, 64, 64, K64, num_iters=2, update_mask=update_mask)
    t = build_scene(2, 64, 64, K64, num_iters=2, update_mask=update_mask, device="cpu")
    return j, t


def _observations(j_scene, t_scene, k):
    """The same observation in both frameworks: the port scene's render with
    a box-filled mask and gt mask."""
    img, mask = t_scene.image.numpy(), t_scene.mask.numpy()
    box = np.array(j_box_fill(jnp.asarray(mask)))
    j_obs = JObservation(jnp.asarray(img), jnp.asarray(box), jnp.asarray(mask), None, jnp.asarray(k))
    t_obs = TObservation(torch.from_numpy(img), torch.from_numpy(box), torch.from_numpy(mask), None,
                         torch.from_numpy(k))
    return j_obs, t_obs


def test_render_at_pose_dryrun_scene():
    """Scene builders agree (config, poses), and render_at_pose of the
    dense 320-face scene matches: hit masks exact, depth 1e-5, rgb 5e-3."""
    (j_ecfg, _, _, j_meshes, j_pose_gt, j_pose0, j_img, j_depth, j_mask), t = _scenes("box_gt")
    np.testing.assert_array_equal(t.pose_gt, j_pose_gt)
    np.testing.assert_array_equal(t.pose0, j_pose0)
    for f in ("height", "width", "tile_h", "tile_w", "max_faces_per_tile", "znear", "zfar",
              "active_tiles", "bin_pairs", "backface_cull", "raster_batch_chunk", "binning"):
        assert getattr(t.ecfg.raster, f) == getattr(j_ecfg.raster, f), f
    for a, b in ((t.image, j_img), (t.depth, j_depth), (t.mask, j_mask)):
        assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_array_equal(t.depth.numpy() > 0, np.asarray(j_depth) > 0)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j_depth), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.image.numpy(), np.asarray(j_img), atol=5e-3, rtol=0)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j_mask))
    # Off-gt pose through the engine entry point.
    j_out = j_render_at_pose(j_meshes, jnp.asarray(j_pose0), jnp.asarray(K64), j_ecfg)
    t_out = t_render_at_pose(t.meshes, torch.from_numpy(t.pose0), torch.from_numpy(K64),
                             t.ecfg, device="cpu")
    np.testing.assert_array_equal(t_out[2].numpy(), np.asarray(j_out[2]))
    np.testing.assert_allclose(t_out[1].numpy(), np.asarray(j_out[1]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("update_mask", ["box_rendered", "box_gt"])
def test_refine_step_teacher_forced(update_mask):
    """The same input pose into one refine_step of each: pose to atol 1e-5,
    zoom factor to atol 1e-5."""
    js, t = _scenes(update_mask)
    j_ecfg, j_meshes = js[0], js[3]
    params, model = _weights((64, 64))
    j_obs, t_obs = _observations(js, t, K64)
    jmodel = JFlowNet(pred_flow=True, pred_mask=True)
    step = jax.jit(lambda p, o, m, x: j_refine_step(p, jmodel, o, m, x, j_ecfg, iter_index=jnp.int32(0)))
    j_pose, j_aux = step(params, j_obs, j_meshes, jnp.asarray(t.pose0))
    with torch.no_grad():
        t_pose, t_aux = t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0),
                                      t.ecfg, iter_index=0, device="cpu")
    np.testing.assert_allclose(t_aux["zoom_factor"].as_array().numpy(),
                               np.asarray(j_aux["zoom_factor"].as_array()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-5, rtol=0)
    assert np.abs(t_pose.numpy() - t.pose0).max() > 1e-4  # the pose moved
    assert int(t_aux["raster_dropped"]) == int(j_aux["raster_dropped"]) == 0


def test_refine_two_iterations():
    """refine for 2 iterations (box_rendered): every intermediate pose to
    atol 1e-4, with a random nonzero translation head in both."""
    js, t = _scenes("box_rendered")
    j_ecfg, j_meshes = js[0], js[3]
    params, model = _weights((64, 64))
    j_obs, t_obs = _observations(js, t, K64)
    jmodel = JFlowNet(pred_flow=True, pred_mask=True)
    run = jax.jit(lambda p, o, m, x: j_refine(p, jmodel, o, m, x, j_ecfg, with_stats=True))
    j_final, j_poses, j_stats = run(params, j_obs, j_meshes, jnp.asarray(t.pose0))
    t_final, t_poses, t_stats = t_refine(model, t_obs, t.meshes, torch.from_numpy(t.pose0),
                                         t.ecfg, with_stats=True, device="cpu")
    assert tuple(t_poses.shape) == (2, 2, 3, 4)
    np.testing.assert_allclose(t_poses.numpy(), np.asarray(j_poses), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t_final.numpy(), t_poses[-1].numpy())
    assert int(t_stats["raster_dropped"]) == int(j_stats["raster_dropped"]) == 0


def test_keep_mask_strategies_agree():
    """'init', 'box_gt' and 'mask_gt' all keep the loader's mask."""
    _, t = _scenes("box_gt")
    _, model = _weights((64, 64))
    _, t_obs = _observations(None, t, K64)
    outs = []
    for um in ("init", "box_gt", "mask_gt"):
        ecfg = t.ecfg.__class__(**{**t.ecfg.__dict__, "update_mask": um})
        with torch.no_grad():
            outs.append(t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0),
                                      ecfg, device="cpu")[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def test_unported_options_raise():
    _, t = _scenes("box_gt")
    _, model = _weights((64, 64))
    _, t_obs = _observations(None, t, K64)
    for kw in (dict(update_mask="box_flow"),):
        ecfg = t.ecfg.__class__(**{**t.ecfg.__dict__, **kw})
        with pytest.raises(NotImplementedError):
            t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0), ecfg, device="cpu")


def test_csr_refine_step_ico4():
    """One refine_step through the CSR path (5,120-face ico4 meshes at
    96x128), the JAX side on its interpreted slots8 kernel."""
    import dataclasses

    js = _build_scene(2, 96, 128, K96, num_iters=1, mesh_detail=4, update_mask="box_gt")
    j_ecfg = dataclasses.replace(js[0], raster=dataclasses.replace(js[0].raster, use_pallas=True))
    t = build_scene(2, 96, 128, K96, num_iters=1, mesh_detail=4, update_mask="box_gt", device="cpu")
    assert t.meshes.faces.shape[1] > 2048 and t.ecfg.raster.bin_pairs == j_ecfg.raster.bin_pairs
    params, model = _weights((96, 128))
    j_obs, t_obs = _observations(js, t, K96)
    jmodel = JFlowNet(pred_flow=True, pred_mask=True)
    step = jax.jit(lambda p, o, m, x: j_refine_step(p, jmodel, o, m, x, j_ecfg))
    j_pose, j_aux = step(params, j_obs, js[3], jnp.asarray(t.pose0))
    with torch.no_grad():
        t_pose, t_aux = t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0),
                                      t.ecfg, device="cpu")
    np.testing.assert_array_equal(t_aux["mask_rendered"].numpy(), np.asarray(j_aux["mask_rendered"]))
    np.testing.assert_allclose(t_aux["depth_rendered"].numpy(), np.asarray(j_aux["depth_rendered"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-5, rtol=0)
    assert int(t_aux["raster_dropped"]) == int(j_aux["raster_dropped"]) == 0


# What the port must not import: JAX and the JAX package, and the
# packages its H100 host does not have.
_BANNED = ("jax", "flax", "optax", "deepim_tpu", "cv2", "PIL", "yaml", "torchvision")


def test_package_import_hygiene():
    """Every deepim_tpu_torch module imports with JAX, deepim_tpu and the
    packages the H100 host lacks (cv2, PIL, yaml, torchvision) made
    unimportable, and no source file of the package or chip_smoke.py
    imports any of them."""
    pkg = REPO / "deepim_tpu_torch"
    sources = [p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts]
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sources
    )
    code = (
        "import sys\n"
        f"for name in {_BANNED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(REPO), timeout=120)
    assert res.returncode == 0, res.stderr
    bad = []
    for p in sources + [REPO / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")) and any(
                tok in s.replace(",", " ").split()
                or any(w.startswith(tok + ".") for w in s.split())
                for tok in _BANNED
            ):
                bad.append(f"{p.name}: {s}")
    assert not bad, bad
