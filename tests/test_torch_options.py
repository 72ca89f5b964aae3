"""Parity of the refine engine's options with the JAX package's, on the CPU,
float32 on both sides: the 'box_observed' mask carried between
iterations, per-class SE(3) heads (group_pick, REGRESSOR_NUM > 1) with
an EULER rotation head, depth input channels (input_depth) and the zoom
factor from the image foregrounds (input_mask=False), in refine_step, in
refine and in a training step; and the wider heads through the weight
bridge.  The scenes are tests/test_torch_refine.py's 64x64 dryrun scene
and tests/test_torch_train.py's 96x128 dense scene; each tolerance is
stated with its reason."""
import dataclasses
import functools
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
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import TrainIterConfig as JTIC  # noqa: E402
from deepim_tpu.engine import Observation as JObservation  # noqa: E402
from deepim_tpu.engine import TrainBatch as JTrainBatch  # noqa: E402
from deepim_tpu.engine import TrainState as JTrainState  # noqa: E402
from deepim_tpu.engine import make_train_step as j_make_train_step  # noqa: E402
from deepim_tpu.engine import refine as j_refine  # noqa: E402
from deepim_tpu.engine import refine_step as j_refine_step  # noqa: E402
from deepim_tpu.engine import lr_schedule as jlr  # noqa: E402
from deepim_tpu.engine import train as jtrain  # noqa: E402
from deepim_tpu.geometry.se3 import RT_transform as j_rt_transform  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops.group_picker import group_pick as j_group_pick  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu_torch.config import TrainConfig, TrainIterConfig  # noqa: E402
from deepim_tpu_torch.engine import TrainBatch, TrainState  # noqa: E402
from deepim_tpu_torch.engine import lr_schedule as tlr  # noqa: E402
from deepim_tpu_torch.engine import refine as t_refine  # noqa: E402
from deepim_tpu_torch.engine import refine_step as t_refine_step  # noqa: E402
from deepim_tpu_torch.engine import train as ttrain  # noqa: E402
from deepim_tpu_torch.engine.refine import Observation as TObservation  # noqa: E402
from deepim_tpu_torch.engine.scene import build_scene  # noqa: E402
from deepim_tpu_torch.geometry.se3 import RT_transform as t_rt_transform  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM as TFlowNet  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.ops.group_picker import group_pick as t_group_pick  # noqa: E402
from test_torch_train import TICFG, _setup  # noqa: E402

torch.set_num_threads(2)
K64 = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)

# Each option set: EngineConfig fields and the network it needs.
OPTIONS = {
    "box_observed": (dict(update_mask="box_observed"), dict()),
    "groups_euler": (dict(rot_type="EULER"), dict(num_regressors=2, rot_dim=3)),
    "input_depth": (dict(input_depth=True), dict(in_ch=10)),
    "no_input_mask": (dict(input_mask=False), dict(in_ch=6)),
}


@functools.lru_cache(maxsize=None)
def _params(hw, num_regressors=1, rot_dim=4, in_ch=8):
    """Full-model JAX parameters (numpy) of the option's network, with
    random nonzero rotation and translation heads (the EULER head and the
    translation head start at zero), and the port's model loaded from
    them through state_dict_from_flax."""
    jm = JFlowNet(num_regressors=num_regressors, rot_dim=rot_dim)
    args = (jnp.zeros((1, *hw, in_ch)),) + ((jnp.zeros((1,), jnp.int32),) if num_regressors > 1 else ())
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(7)
    head = params["params"]
    head["trans"]["kernel"] = (rng.randn(256, 3 * num_regressors) * 0.05).astype(np.float32)
    head["trans"]["bias"] = (rng.randn(3 * num_regressors) * 0.01).astype(np.float32)
    if rot_dim == 3:
        head["rot"]["kernel"] = (rng.randn(256, 3 * num_regressors) * 0.5).astype(np.float32)
    model = TFlowNet(in_channels=in_ch, input_hw=hw, num_regressors=num_regressors, rot_dim=rot_dim,
                     device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return params, jm, model.eval()


@functools.lru_cache(maxsize=None)
def _scene(update_mask):
    js = _build_scene(2, 64, 64, K64, num_iters=4, update_mask=update_mask)
    t = build_scene(2, 64, 64, K64, num_iters=4, update_mask=update_mask, device="cpu")
    return js, t


def _observations(t):
    """The same observation in both packages: the port scene's render with
    a box-filled mask, its mask as gt mask, its depth as observed depth and
    its class ids."""
    img, mask, depth = t.image.numpy(), t.mask.numpy(), t.depth.numpy()
    box = np.array(j_box_fill(jnp.asarray(mask)))
    cls = t.cls_idx.astype(np.int32)
    j_obs = JObservation(image_observed=jnp.asarray(img), mask_observed=jnp.asarray(box),
                         mask_gt_observed=jnp.asarray(mask), depth_observed=jnp.asarray(depth),
                         k=jnp.asarray(K64), class_index=jnp.asarray(cls))
    t_obs = TObservation(image_observed=torch.from_numpy(img), mask_observed=torch.from_numpy(box),
                         mask_gt_observed=torch.from_numpy(mask), depth_observed=torch.from_numpy(depth),
                         k=torch.from_numpy(K64), class_index=torch.from_numpy(cls))
    return j_obs, t_obs


def _option(name):
    fields, net = OPTIONS[name]
    update_mask = fields.get("update_mask", "box_rendered")
    js, t = _scene(update_mask)
    j_ecfg = dataclasses.replace(js[0], **fields)
    t_ecfg = dataclasses.replace(t.ecfg, **fields)
    return js, t, j_ecfg, t_ecfg, _params((64, 64), **net)


# --- A4: group_pick, the EULER head, the bridge -------------------------------------


def test_group_pick_matches_jax(rng):
    """group_pick forward (0-based ids, and ids >= num_groups read 1-based)
    and its gradient (a scatter to the picked group) equal the JAX
    package's exactly."""
    b, g, c = 6, 4, 3
    x = rng.rand(b, g * c).astype(np.float32)
    for idx in (rng.randint(0, g, size=b), rng.randint(1, g + 1, size=b)):
        idx = idx.astype(np.int32)
        xt = torch.from_numpy(x).requires_grad_()
        out = t_group_pick(xt, torch.from_numpy(idx), g)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_group_pick(jnp.asarray(x), idx, g)))
        w = rng.randn(b, c).astype(np.float32)
        (out * torch.from_numpy(w)).sum().backward()
        jg = jax.grad(lambda v: (j_group_pick(v, idx, g) * w).sum())(jnp.asarray(x))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    with pytest.raises(ValueError):
        t_group_pick(torch.zeros(2, 7), torch.zeros(2, dtype=torch.long), 2)


def test_euler_head_starts_at_identity():
    """A seeded EULER network (rot_dim=3, per-class groups) predicts zero
    angles, so RT_transform keeps every rotation, as JAX's zero-initialised
    head does."""
    model = TFlowNet(input_hw=(64, 64), pred_flow=False, pred_mask=False, num_regressors=2, rot_dim=3,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 8, 64, 64).astype(np.float32))
    with torch.no_grad():
        out = model(x, torch.tensor([0, 1]))
    assert out["rot"].shape == (2, 3) and not out["rot"].any()
    pose = torch.eye(3, 4).repeat(2, 1, 1)
    pose[:, 2, 3] = 0.6
    new = t_rt_transform(pose, out["rot"], out["trans"])
    assert torch.equal(new[:, :, :3], pose[:, :, :3])
    with pytest.raises(ValueError, match="class_index"):
        model(x)


def test_rt_transform_euler_matches_jax(rng):
    """RT_transform with 'sxyz' Euler deltas, CAMERA and MODEL
    coordinates: atol 1e-6 (float32 rotation algebra)."""
    pose = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)),
                           rng.uniform(-0.05, 0.05, (4, 3, 1)).astype(np.float32)], 2)
    pose[:, 2, 3] = 0.6
    eul = rng.uniform(-0.3, 0.3, (4, 3)).astype(np.float32)
    t = rng.uniform(-0.05, 0.05, (4, 3)).astype(np.float32)
    for rc in ("CAMERA", "MODEL"):
        got = t_rt_transform(torch.from_numpy(pose), torch.from_numpy(eul), torch.from_numpy(t), rot_coord=rc)
        ref = j_rt_transform(jnp.asarray(pose), jnp.asarray(eul), jnp.asarray(t), rot_coord=rc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0, err_msg=rc)


def test_wide_heads_bridge_and_match_jax():
    """state_dict_from_flax bridges a two-group EULER network (rot (6, 256),
    trans (6, 256)), and the port's network picks each sample's group as
    JAX's does: rot and trans to atol 1e-5, flow and mask to 1e-4 (the
    float32 tolerances of tests/test_torch_flownet.py), for 0-based and
    1-based class ids."""
    params, jm, model = _params((64, 64), num_regressors=2, rot_dim=3)
    assert tuple(model.rot.weight.shape) == (6, 256) and tuple(model.trans.weight.shape) == (6, 256)
    x = np.random.RandomState(3).rand(3, 64, 64, 8).astype(np.float32)
    for ids in ([0, 1, 1], [1, 2, 1]):
        ci = np.asarray(ids, np.int32)
        j_out = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ci))
        with torch.no_grad():
            t_out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(ci))
        assert t_out["rot"].shape == (3, 3)
        for key in ("rot", "trans"):
            np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), atol=1e-5, rtol=0)
        for key in ("flow", "mask_logit"):
            np.testing.assert_allclose(t_out[key].permute(0, 2, 3, 1).numpy(), np.asarray(j_out[key]),
                                       atol=1e-4, rtol=0, err_msg=key)
    assert np.abs(np.asarray(j_out["rot"])).max() > 1e-3


# --- refine_step and refine ------------------------------------------------------


@pytest.mark.parametrize("option", ["groups_euler", "input_depth", "no_input_mask"])
def test_refine_step_option_matches_jax(option):
    """One refine_step with the option on (the 64x64 scene): zoom factor
    and new pose to atol 1e-5, as tests/test_torch_refine.py's float32
    refine_step; the option changes the step (the pose differs from the
    start pose)."""
    js, t, j_ecfg, t_ecfg, (params, jm, model) = _option(option)
    j_obs, t_obs = _observations(t)
    step = jax.jit(lambda p, o, m, x: j_refine_step(p, jm, o, m, x, j_ecfg, iter_index=jnp.int32(0)))
    j_pose, j_aux = step(params, j_obs, js[3], jnp.asarray(t.pose0))
    with torch.no_grad():
        t_pose, t_aux = t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0), t_ecfg,
                                      iter_index=0, device="cpu")
    np.testing.assert_allclose(t_aux["zoom_factor"].as_array().numpy(),
                               np.asarray(j_aux["zoom_factor"].as_array()), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-5, rtol=0)
    assert np.abs(t_pose.numpy() - t.pose0).max() > 1e-4
    if option == "no_input_mask":
        assert t_aux["zoom_mask_gt_observed"] is None


def test_box_observed_refine_carries_predicted_mask():
    """refine, 4 iterations, under 'box_observed': each iteration boxes the
    previous one's predicted mask (sigmoid, inverse zoom, binarised).
    Every iteration's pose to atol 1e-4 (tests/test_torch_refine.py's
    refine tolerance) and the first step's full-frame predicted mask equal
    to JAX's; refine's second pose is refine_step's from the first step's
    carried mask."""
    js, t, j_ecfg, t_ecfg, (params, jm, model) = _option("box_observed")
    j_obs, t_obs = _observations(t)
    j_pose, j_aux = jax.jit(lambda p, o, m, x: j_refine_step(p, jm, o, m, x, j_ecfg))(
        params, j_obs, js[3], jnp.asarray(t.pose0))
    with torch.no_grad():
        t_pose, t_aux = t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0), t_ecfg, device="cpu")
    pred = t_aux["mask_pred_full"]
    np.testing.assert_array_equal(pred.numpy(), np.asarray(j_aux["mask_pred_full"]))
    assert pred.shape == (2, 1, 64, 64) and 0 < float(pred.sum()) < pred.numel()
    _, j_poses = jax.jit(lambda p, o, m, x: j_refine(p, jm, o, m, x, j_ecfg))(
        params, j_obs, js[3], jnp.asarray(t.pose0))
    _, t_poses = t_refine(model, t_obs, t.meshes, torch.from_numpy(t.pose0), t_ecfg, device="cpu")
    assert t_poses.shape == (4, 2, 3, 4)
    np.testing.assert_allclose(t_poses.numpy(), np.asarray(j_poses), atol=1e-4, rtol=0)
    with torch.no_grad():
        second, _ = t_refine_step(model, t_obs, t.meshes, t_pose, t_ecfg, iter_index=1,
                                  mask_observed_state=pred, device="cpu")
    assert torch.equal(t_poses[0], t_pose) and torch.equal(t_poses[1], second)


# --- a training step ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _train_both(option):
    """One 1-inner-iteration train step of each package (the dense 96x128
    scene, the reference SGD recipe at lr 1e-3) with the option set on;
    the batch carries observed depth (the gt render) for input_depth."""
    j_ecfg, t_ecfg, bank_np, arrs = _setup("dense")
    arrs = dict(arrs, depth_observed=arrs["depth_gt_observed"][:, None])
    fields = {"box_observed": dict(update_mask="box_observed", rot_type="EULER", input_depth=True),
              "no_input_mask": dict(input_mask=False)}[option]
    net = dict(num_regressors=2, rot_dim=3, in_ch=10) if option == "box_observed" else dict(in_ch=6)
    j_ecfg = dataclasses.replace(j_ecfg, num_iters=1, **fields)
    t_ecfg = dataclasses.replace(t_ecfg, num_iters=1, **fields)
    ticfg = dict(TICFG, LW_MASK=0.03 if fields.get("input_mask", True) else 0.0)
    params, jm, model = _params((t_ecfg.height, t_ecfg.width), **net)
    tx = jtrain.make_optimizer(JConfig(), jlr.warmup_multifactor_schedule(1e-3, (10000,)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JTrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(j_make_train_step(jm, tx, j_ecfg, JTIC(**ticfg), "viz"))
    jb = JTrainBatch(**{k: jnp.asarray(v) for k, v in arrs.items()})
    jstate, j_m, j_pose = jstep(jstate, jb, tuple(map(jnp.asarray, bank_np)))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, ttrain.make_optimizer(model.parameters(), TrainConfig(),
                                                    tlr.warmup_multifactor_schedule(1e-3, (10000,))))
    step = ttrain.make_train_step(t_ecfg, TrainIterConfig(**ticfg), "viz", device="cpu")
    tb = TrainBatch(**{k: torch.from_numpy(np.array(v, copy=True)) for k, v in arrs.items()})
    state, t_m, t_pose = step(state, tb, bank_np)
    j_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    return (j_sd, {k: np.asarray(v) for k, v in j_m.items()}, np.asarray(j_pose), sd0, state,
            {k: v.numpy() for k, v in t_m.items()}, t_pose.numpy())


@pytest.mark.parametrize("option", ["box_observed", "no_input_mask"])
def test_train_step_option_matches_jax(option):
    """A train step with 'box_observed' masks, two per-class EULER head
    groups and depth input channels, and one with input_mask=False (no
    mask channels, no mask loss): losses rtol 1e-4, parameters within 4 ulp
    of their magnitude plus 2% of the tensor's update, the new pose atol
    1e-5 (tests/test_torch_train.py's float32 step tolerances); every
    parameter that JAX updates moves."""
    j_sd, j_m, j_pose, sd0, state, t_m, t_pose = _train_both(option)
    for key in ("pm_loss", "flow_loss", "total") + (("mask_loss",) if option == "box_observed" else ()):
        assert np.isfinite(t_m[key]).all()
        np.testing.assert_allclose(t_m[key], j_m[key], rtol=1e-4, err_msg=key)
    assert ("mask_loss" in t_m) == ("mask_loss" in j_m)
    moved = 0
    for name, p in state.model.state_dict().items():
        ref, p0 = j_sd[name].numpy(), sd0[name].numpy()
        delta = float(np.abs(ref - p0).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(ref).max()))) + 2e-2 * delta
        np.testing.assert_allclose(p.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        moved += (delta > 0) == (not np.array_equal(p.numpy(), p0))
    assert moved == len(j_sd)
    np.testing.assert_allclose(t_pose, j_pose, atol=1e-5, rtol=0)
