"""Parity of the port's training slice (deepim_tpu_torch: ops.flow, ops.zoom
zoom_flow, ops.pointmatch, geometry.se3 deltas, engine.losses,
engine.lr_schedule, engine.train) with the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX weights are carried across with
state_dict_from_flax.  The whole-step tests run the JAX step under jit, as
the JAX package runs it.  Two roundings are matched on purpose so that the
comparison is tight: the zoom's sample coordinates (XLA contracts
wx * g + tx into one FMA, and the port rounds it the same way, see
ops/sampler._fma32), and LeakyReLU's derivative at exactly 0 (1, as JAX's
where(x >= 0, ...) gives; models/flownet._Leaky).  Each tolerance below is
stated with its reason."""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp
import optax

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.config import Config  # noqa: E402
from deepim_tpu.config import TrainIterConfig as JTIC  # noqa: E402
from deepim_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from deepim_tpu.engine import MeshBuffers as JMeshBuffers  # noqa: E402
from deepim_tpu.engine import TrainBatch as JTrainBatch  # noqa: E402
from deepim_tpu.engine import TrainState as JTrainState  # noqa: E402
from deepim_tpu.engine import make_train_step as j_make_train_step  # noqa: E402
from deepim_tpu.engine import render_at_pose as j_render_at_pose  # noqa: E402
from deepim_tpu.engine import losses as jl  # noqa: E402
from deepim_tpu.engine import lr_schedule as jlr  # noqa: E402
from deepim_tpu.engine import train as jtrain  # noqa: E402
from deepim_tpu.geometry import projection as jproj  # noqa: E402
from deepim_tpu.geometry import rotations as jrot  # noqa: E402
from deepim_tpu.geometry import se3 as jse3  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops import flow as jflow  # noqa: E402
from deepim_tpu.ops import pointmatch as jpm  # noqa: E402
from deepim_tpu.ops import sampler as jsamp  # noqa: E402
from deepim_tpu.ops import zoom as jzoom  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu.render.mesh import MeshBank, make_icosphere, make_test_cube  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu_torch.config import TrainConfig, TrainIterConfig  # noqa: E402
from deepim_tpu_torch.engine import EngineConfig, MeshBuffers, TrainBatch, TrainState  # noqa: E402
from deepim_tpu_torch.engine import losses as tl  # noqa: E402
from deepim_tpu_torch.engine import lr_schedule as tlr  # noqa: E402
from deepim_tpu_torch.engine import train as ttrain  # noqa: E402
from deepim_tpu_torch.engine.scene import build_scene, train_batch  # noqa: E402
from deepim_tpu_torch.geometry import projection as tproj  # noqa: E402
from deepim_tpu_torch.geometry import se3 as tse3  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM as TFlowNet  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.ops import flow as tflow  # noqa: E402
from deepim_tpu_torch.ops import pointmatch as tpm  # noqa: E402
from deepim_tpu_torch.ops import sampler as tsamp  # noqa: E402
from deepim_tpu_torch.ops import zoom as tzoom  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402

torch.set_num_threads(2)

H, W = 96, 128
K_MAT = np.array([[140.0, 0.0, 64.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]], np.float32)
RASTER = dict(height=H, width=W, tile_h=8, tile_w=64, max_faces_per_tile=128, chunk=16,
              znear=0.05, zfar=10.0)
# tests/test_engine.py's training recipe at this size.
TICFG = dict(SE3_PM_LOSS=True, LW_PM=0.1, SE3_PM_LOSS_TYPE="L1", NUM_3D_SAMPLE=64,
             LW_FLOW=0.25, LW_MASK=0.03)
N_PTS = 64


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _poses(rng, b):
    """tests/test_engine.py's pose model: gt pose plus a perturbed start."""
    rot = R.from_euler("xyz", rng.uniform(-0.4, 0.4, (b, 3))).as_matrix().astype(np.float32)
    pose_gt = np.concatenate([rot, np.zeros((b, 3, 1), np.float32)], 2)
    pose_gt[:, 2, 3] = 0.55
    pose_gt[:, 0, 3] = rng.uniform(-0.03, 0.03, b)
    pose_gt[:, 1, 3] = rng.uniform(-0.03, 0.03, b)
    noise = R.from_euler("xyz", rng.uniform(-0.15, 0.15, (b, 3))).as_matrix().astype(np.float32)
    pose0 = pose_gt.copy()
    pose0[:, :, :3] = np.einsum("bij,bjk->bik", noise, pose_gt[:, :, :3])
    pose0[:, :, 3] += rng.uniform(-0.01, 0.01, (b, 3)).astype(np.float32)
    pose0[:, 2, 3] = np.maximum(pose0[:, 2, 3], 0.3)
    return pose_gt, pose0


@functools.lru_cache(maxsize=None)
def _setup(kind):
    """(JAX ecfg, port ecfg, bank arrays, batch arrays) of a b=2 scene:
    'dense' is tests/test_engine.py's cube + ico1 scene; 'planes64' two
    5,120-face ico4 meshes on the CSR path with the planes64 kernel (the
    JAX side runs its Pallas kernel in interpret mode)."""
    b = 2
    if kind == "dense":
        meshes, pad, extra = [make_test_cube(0.08), make_icosphere(0.05, 1)], 64, {}
    else:
        meshes, pad = [make_icosphere(0.05, 4), make_icosphere(0.06, 4)], 128
        extra = dict(binning="csr", bin_pairs=5120 * 16, csr_kernel="planes64")
    jcfg = JRasterConfig(**RASTER, **extra, use_pallas=kind != "dense")
    tcfg = RasterConfig(**RASTER, **extra)
    common = dict(height=H, width=W, update_mask="box_gt", num_iters=2, normalize_flow=20.0)
    j_ecfg, t_ecfg = JEngineConfig(raster=jcfg, **common), EngineConfig(raster=tcfg, **common)
    bank = MeshBank.from_meshes(meshes, pad_multiple=pad)
    bank_np = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
    cls = (np.arange(b) % 2).astype(np.int32)
    pose_gt, pose0 = _poses(np.random.RandomState(42), b)
    jm = JMeshBuffers.gather(tuple(map(jnp.asarray, bank_np)), jnp.asarray(cls))
    img, depth, mask = (np.asarray(x) for x in j_render_at_pose(jm, jnp.asarray(pose_gt), jnp.asarray(K_MAT),
                                                               j_ecfg))
    arrs = dict(
        image_observed=img, mask_observed=np.asarray(j_box_fill(jnp.asarray(mask))),
        mask_gt_observed=mask, depth_gt_observed=depth[:, 0], pose_rendered=pose0,
        pose_observed=pose_gt, class_index=cls, points_model=bank.vertices[cls][:, :N_PTS],
        points_weights=np.ones((b, N_PTS), np.float32), k=K_MAT,
    )
    return j_ecfg, t_ecfg, bank_np, arrs


@functools.lru_cache(maxsize=None)
def _params():
    """Full-model JAX parameters (numpy) with a random nonzero trans head."""
    params = JFlowNet(pred_flow=True, pred_mask=True).init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    return params


def _port_model():
    model = TFlowNet(input_hw=(H, W), device="cpu")
    model.load_state_dict(state_dict_from_flax(_params()))
    return model


def _batches(arrs):
    j = JTrainBatch(**{k: jnp.asarray(v) for k, v in arrs.items()})
    t = TrainBatch(**{k: _t(v) for k, v in arrs.items()})
    return j, t


def _assert_grads_close(t_named, j_tree, rel):
    """Every port gradient against JAX's, per tensor, relative to JAX's
    max |g| of that tensor."""
    j_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, j_tree))
    names = []
    for name, g in t_named:
        ref = j_sd[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max()) / scale
        assert err <= rel, (name, err, scale)
        names.append(name)
    assert sorted(names) == sorted(j_sd)


# --- geometry, flow, zoom_flow, transform3d ---------------------------------


@pytest.mark.parametrize("rot_coord", ["CAMERA", "MODEL", "CAMERA_NEW", "NAIVE"])
def test_calc_rt_delta_matches_jax(rng, rot_coord):
    """R_inv_transform / T_inv_transform via calc_RT_delta, and the QUAT
    label mat2quat of the delta: atol 1e-6 (float32 3x3 products)."""
    pose_gt, pose0 = _poses(rng, 5)
    t_means, t_stds = np.float32([0.01, -0.02, 0.0]), np.float32([1.0, 2.0, 0.5])
    r_t, t_t = tse3.calc_RT_delta(_t(pose0), _t(pose_gt), _t(t_means), _t(t_stds), rot_coord)
    r_j, t_j = jse3.calc_RT_delta(jnp.asarray(pose0), jnp.asarray(pose_gt), jnp.asarray(t_means),
                                  jnp.asarray(t_stds), rot_coord)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-6, rtol=0)
    if rot_coord != "NAIVE":
        # RT_transform undoes the delta.
        from deepim_tpu_torch.geometry.rotations import mat2quat
        back = tse3.RT_transform(_t(pose0), mat2quat(r_t), t_t, _t(t_means), _t(t_stds), rot_coord)
        np.testing.assert_allclose(back.numpy(), pose_gt, atol=1e-5, rtol=0)
        np.testing.assert_allclose(mat2quat(r_t).numpy(), np.asarray(jrot.mat2quat(r_j)), atol=1e-6)
    hh, ww = tproj.pixel_grid(3, 5)
    jh, jw = jproj.pixel_grid(3, 5)
    np.testing.assert_array_equal(hh.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ww.numpy(), np.asarray(jw))


def _depth_pair():
    """Rendered depth at the start pose and the gt depth of the dense scene."""
    j_ecfg, _, bank_np, arrs = _setup("dense")
    jm = JMeshBuffers.gather(tuple(map(jnp.asarray, bank_np)), jnp.asarray(arrs["class_index"]))
    depth0 = np.asarray(j_render_at_pose(jm, jnp.asarray(arrs["pose_rendered"]), jnp.asarray(K_MAT),
                                         j_ecfg)[1])[:, 0]
    return depth0, arrs


@pytest.mark.parametrize("standard_rep", [False, True])
def test_flow_from_depth_and_gather_match_jax(standard_rep):
    """Flow labels between the start-pose render and the gt depth: valid
    masks exact, flow atol 1e-4 px (float32 reprojection through two 3x4
    products and a division, values up to tens of px); the visible-mask
    gather at the flow targets exact."""
    depth0, arrs = _depth_pair()
    args = (depth0, arrs["depth_gt_observed"], arrs["pose_rendered"], arrs["pose_observed"], K_MAT)
    f_t, v_t = tflow.flow_from_depth(*map(_t, args), standard_rep=standard_rep)
    f_j, v_j = jax.jit(functools.partial(jflow.flow_from_depth, standard_rep=standard_rep))(
        *map(jnp.asarray, args))
    assert float(v_t.sum()) > 100
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-4, rtol=0)
    m = arrs["mask_gt_observed"][:, 0]
    g_t = tflow.gather_at_flow_target(_t(m), f_t, standard_rep=standard_rep)
    g_j = jflow.gather_at_flow_target(jnp.asarray(m), jnp.asarray(f_t.numpy()), standard_rep=standard_rep)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("inverse", [False, True])
def test_zoom_flow_matches_jax(rng, inverse):
    """zoom_flow against the JAX package under jit.  The port reproduces
    XLA's FMA rounding of the sample coordinates (ops/sampler._fma32), so
    the interpolation weights are identical: zoomed weights exact, flow atol
    1e-5 (the resample matmuls' two-term sums, about 1 ulp of flows up to
    ~15 px).  Measured on the CPU at 640 px: 3.8e-6 forward and inverse."""
    b = 4
    wx = rng.uniform(0.3, 1.2, b).astype(np.float32)
    zf = [wx, wx.copy(), rng.uniform(-0.5, 0.5, b).astype(np.float32),
          rng.uniform(-0.5, 0.5, b).astype(np.float32)]
    flow = (rng.randn(b, 2, H, W) * 5).astype(np.float32)
    weights = (rng.rand(b, 2, H, W) > 0.3).astype(np.float32)
    tz = tsamp.ZoomFactor(*map(_t, zf))
    if inverse:
        t_out = [tzoom.zoom_flow(_t(flow), tz, inverse=True)]
        j_out = [jax.jit(lambda f, *z: jzoom.zoom_flow(f, jsamp.ZoomFactor(*z), inverse=True))(
            jnp.asarray(flow), *map(jnp.asarray, zf))]
    else:
        t_out = tzoom.zoom_flow(_t(flow), tz, _t(weights))
        j_out = jax.jit(lambda f, w, *z: jzoom.zoom_flow(f, jsamp.ZoomFactor(*z), w))(
            jnp.asarray(flow), jnp.asarray(weights), *map(jnp.asarray, zf))
        np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
        assert set(np.unique(t_out[1].numpy())) <= {0.0, 1.0}
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]), atol=1e-5, rtol=0)
    assert not t_out[0].requires_grad


def test_transform3d_matches_jax(rng):
    """Points and the gradients to (quat, trans) against jax.vjp: atol
    1e-6 / rtol 1e-5 (float32 rotation algebra); the points and the source
    pose receive no gradient."""
    b, n = 3, 20
    pts = (rng.randn(b, n, 3) * 0.05).astype(np.float32)
    quat = (rng.randn(b, 4) * 0.1 + np.array([1, 0, 0, 0])).astype(np.float32)
    trans = (rng.randn(b, 3) * 0.01).astype(np.float32)
    _, pose0 = _poses(rng, b)
    g = rng.randn(b, n, 3).astype(np.float32)
    j_out, vjp = jax.vjp(lambda q, t: jpm.transform3d(jnp.asarray(pts), q, t, jnp.asarray(pose0)),
                         jnp.asarray(quat), jnp.asarray(trans))
    jq, jt = vjp(jnp.asarray(g))
    tq, tt, tp, tpose = (_t(x).requires_grad_(True) for x in (quat, trans, pts, pose0))
    out = tpm.transform3d(tp, tq, tt, tpose)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jq), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jt), atol=1e-6, rtol=1e-5)
    assert tp.grad is None and tpose.grad is None


# --- losses, schedule, optimizer --------------------------------------------


_LOSS_CASES = [
    ("pm", dict(SE3_PM_LOSS_TYPE="L1")), ("pm", dict(SE3_PM_LOSS_TYPE="L2")),
    ("pm", dict(SE3_PM_LOSS_TYPE="smooth_L1", SE3_PM_SL1_SCALAR=3.0)),
    ("se3", dict(TRANS_LOSS_TYPE="L2")), ("se3", dict(TRANS_LOSS_TYPE="L1")),
    ("se3", dict(TRANS_LOSS_TYPE="smooth_L1")), ("flow", {}), ("mask", {}),
]


@pytest.mark.parametrize("kind,kw", _LOSS_CASES, ids=[f"{k}-{list(v.values())}" for k, v in _LOSS_CASES])
def test_losses_match_jax(rng, kind, kw):
    """Each loss and its gradient to the prediction against jax.grad: value
    rtol 1e-5, gradient atol 1e-7 / rtol 1e-5 (float32 sums); labels get no
    gradient."""
    cfg = dict(LW_PM=0.1, NUM_3D_SAMPLE=30, LW_ROT=0.5, LW_TRANS=2.0, **kw)
    jcfg, tcfg = JTIC(**cfg), TrainIterConfig(**cfg)
    b = 3
    if kind == "pm":
        est, lab = (rng.randn(b, 30, 3) * 0.02).astype(np.float32), (rng.randn(b, 30, 3) * 0.02).astype(np.float32)
        extra = ((rng.rand(b, 30) > 0.2).astype(np.float32),)
        jf = lambda e, l, w: jl.point_matching_loss(e, l, w, jcfg, 0.1)  # noqa: E731
        tf = lambda e, l, w: tl.point_matching_loss(e, l, w, tcfg, 0.1)  # noqa: E731
    elif kind == "se3":
        est, lab = rng.randn(b, 4).astype(np.float32), rng.randn(b, 4).astype(np.float32)
        extra = ((rng.randn(b, 3) * 0.3).astype(np.float32), (rng.randn(b, 3) * 0.3).astype(np.float32))
        jf = lambda e, l, te, tg: sum(jl.se3_dist_loss(e, te, l, tg, jcfg))  # noqa: E731
        tf = lambda e, l, te, tg: sum(tl.se3_dist_loss(e, te, l, tg, tcfg))  # noqa: E731
    elif kind == "flow":
        est, lab = rng.randn(b, 2, 8, 10).astype(np.float32), (rng.randn(b, 2, 8, 10) * 20).astype(np.float32)
        extra = ((rng.rand(b, 2, 8, 10) > 0.5).astype(np.float32),)
        jf = lambda e, l, w: jl.flow_loss(e, l, w, 20.0, 0.25, 80.0)  # noqa: E731
        tf = lambda e, l, w: tl.flow_loss(e, l, w, 20.0, 0.25, 80.0)  # noqa: E731
    else:
        est, lab = (rng.randn(b, 1, 8, 10) * 3).astype(np.float32), (rng.rand(b, 1, 8, 10) > 0.5).astype(np.float32)
        extra = ()
        jf = lambda e, l: jl.mask_loss(e, l, 0.03)  # noqa: E731
        tf = lambda e, l: tl.mask_loss(e, l, 0.03)  # noqa: E731
    j_val, j_grad = jax.value_and_grad(jf)(jnp.asarray(est), jnp.asarray(lab), *map(jnp.asarray, extra))
    te, tlab = _t(est).requires_grad_(True), _t(lab).requires_grad_(True)
    val = tf(te, tlab, *map(_t, extra))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(j_grad), atol=1e-7, rtol=1e-5)
    if kind in ("pm", "mask"):
        assert tlab.grad is None
    x = rng.randn(50).astype(np.float32)
    np.testing.assert_allclose(tl.smooth_l1(_t(x), 2.0).numpy(), np.asarray(jl.smooth_l1(jnp.asarray(x), 2.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup", [False, True])
def test_lr_schedule_matches_jax(warmup):
    """warmup_multifactor_schedule over the update count, and the epoch
    list parser: equal."""
    args = (1e-4, (10, 25), 0.1, warmup, 1e-5, 7)
    j, t = jlr.warmup_multifactor_schedule(*args), tlr.warmup_multifactor_schedule(*args)
    for count in range(0, 40, 3):
        assert t(count) == float(np.asarray(j(jnp.int32(count)))), count
    assert tlr.lr_steps_from_config("4, 6", 100, 5) == jlr.lr_steps_from_config("4, 6", 100, 5) == (600,)


def _optimizers(name, clip, skip=True, lr=1e-2):
    cfg = dataclasses.replace(Config(), TRAIN=dataclasses.replace(
        Config().TRAIN, optimizer=name, grad_clip=clip, skip_nonfinite=skip))
    tcfg = TrainConfig(optimizer=name, grad_clip=clip, skip_nonfinite=skip)
    sched = (10, 20)
    return (jtrain.make_optimizer(cfg, jlr.warmup_multifactor_schedule(lr, sched, 0.5, True, lr / 3, 2)),
            lambda params: ttrain.make_optimizer(params, tcfg, tlr.warmup_multifactor_schedule(
                lr, sched, 0.5, True, lr / 3, 2)))


def _opt_run(name, clip, grads_seq, skip=True):
    """Apply the same gradient sequence to {'w', 'b'} through optax and the
    port; returns (jax params, port params, port optimizer)."""
    rng = np.random.RandomState(3)
    p0 = {"w": rng.randn(4, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    tx, make = _optimizers(name, clip, skip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = make([tp["w"], tp["b"]])
    @jax.jit
    def jstep(g, state, jp):
        updates, state = tx.update(g, state, jp)
        return optax.apply_updates(jp, updates), state

    for g in grads_seq:
        jp, state = jstep({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        for k in tp:
            tp[k].grad = _t(g[k])
        opt.step()
    return jp, tp, opt


@pytest.mark.parametrize("name", ["sgd", "adam"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_matches_optax(name, clip):
    """Five updates of SGD (momentum, decoupled-into-gradient weight decay)
    or AdamW, with and without global-norm clipping, through a warmup and
    a decay step of the schedule: parameters atol 1e-6 (float32 update
    arithmetic in another order)."""
    rng = np.random.RandomState(1)
    grads = [{"w": rng.randn(4, 5).astype(np.float32) * s, "b": rng.randn(5).astype(np.float32) * s}
             for s in (0.1, 1.0, 3.0, 0.5, 2.0)]
    jp, tp, opt = _opt_run(name, clip, grads)
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    assert opt.count == 5


def test_skip_nonfinite_matches_optax():
    """apply_if_finite: a NaN step leaves parameters and state untouched
    (the next finite step equals optax's), 100 consecutive NaN steps are
    skipped and the 101st is applied; with the knob off NaN propagates."""
    rng = np.random.RandomState(2)
    good = {"w": rng.randn(4, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    bad = {"w": np.full((4, 5), np.nan, np.float32), "b": np.zeros(5, np.float32)}
    jp, tp, opt = _opt_run("sgd", 0.0, [good, bad, good])
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    assert (opt.count, opt.notfinite_count) == (2, 0)
    jp, tp, opt = _opt_run("sgd", 0.0, [good] + [bad] * 100)
    assert np.isfinite(np.asarray(jp["w"])).all() and torch.isfinite(tp["w"]).all()
    assert (opt.count, opt.notfinite_count) == (1, 100)
    jp, tp, opt = _opt_run("sgd", 0.0, [good] + [bad] * 101)
    assert np.isnan(np.asarray(jp["w"])).all() and torch.isnan(tp["w"]).all()
    assert opt.count == 2
    jp, tp, opt = _opt_run("adam", 0.0, [bad], skip=False)
    assert np.isnan(np.asarray(jp["w"])).all() and torch.isnan(tp["w"]).all()


def test_unknown_optimizer_and_flow_weight_type_raise():
    with pytest.raises(ValueError):
        ttrain.make_optimizer([torch.nn.Parameter(torch.zeros(2))], TrainConfig(optimizer="rmsprop"),
                              tlr.warmup_multifactor_schedule(1e-3, ()))
    with pytest.raises(ValueError):
        ttrain.flow_weights_from_valid(torch.zeros(1, 2, 2), "bogus", torch.zeros(1, 2, 2))


@pytest.mark.parametrize("weight_type", ["all", "viz", "valid"])
def test_flow_weights_from_valid_matches_jax(rng, weight_type):
    valid = (rng.rand(2, 6, 7) > 0.5).astype(np.float32)
    depth = np.where(rng.rand(2, 6, 7) > 0.5, 0.0, 0.6).astype(np.float32)
    np.testing.assert_array_equal(
        ttrain.flow_weights_from_valid(_t(valid), weight_type, _t(depth)).numpy(),
        np.asarray(jtrain.flow_weights_from_valid(jnp.asarray(valid), weight_type, jnp.asarray(depth))))


# --- compute_losses and the whole step --------------------------------------


@pytest.mark.parametrize("flow_weight_type", ["viz", "viz_visible"])
def test_compute_losses_and_gradients_match_jax(flow_weight_type):
    """compute_losses at the start pose of the dense scene with every loss
    on (point matching, SE(3) distance, flow, mask): each loss rtol 1e-5
    plus atol 1e-7 (the rotation loss 1 - (q_gt . q)^2 cancels to ~5e-3),
    and every parameter's gradient within 1e-4 of JAX's, per tensor,
    relative to its max |g| (float32 convolutions in another order;
    measured on the CPU: 3e-6)."""
    j_ecfg, t_ecfg, bank_np, arrs = _setup("dense")
    cfg = dict(TICFG, SE3_DIST_LOSS=True, LW_ROT=0.5, LW_TRANS=0.5)
    jb, tb = _batches(arrs)
    jm = JMeshBuffers.gather(tuple(map(jnp.asarray, bank_np)), jb.class_index)
    jmodel = JFlowNet(pred_flow=True, pred_mask=True)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtrain.compute_losses(p, jmodel, jb, jm, jb.pose_rendered, j_ecfg, JTIC(**cfg),
                                        flow_weight_type), has_aux=True))
    (_, (j_pose, j_losses)), j_grads = fn(jax.tree_util.tree_map(jnp.asarray, _params()))
    model = _port_model()
    meshes = MeshBuffers.gather(bank_np, arrs["class_index"], device="cpu")
    total, (t_pose, t_losses) = ttrain.compute_losses(
        model, tb, meshes, tb.pose_rendered, t_ecfg, TrainIterConfig(**cfg), flow_weight_type, device="cpu")
    total.backward()
    for key in ("pm_loss", "rot_loss", "trans_loss", "flow_loss", "mask_loss", "total"):
        np.testing.assert_allclose(float(t_losses[key].detach()), float(j_losses[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    assert int(t_losses["raster_dropped"]) == int(j_losses["raster_dropped"]) == 0
    np.testing.assert_allclose(t_pose.detach().numpy(), np.asarray(j_pose), atol=1e-5, rtol=0)
    _assert_grads_close([(n, p.grad) for n, p in model.named_parameters()], j_grads, rel=1e-4)


@functools.lru_cache(maxsize=None)
def _train_both(kind, lr=1e-3):
    """One 2-inner-iteration train step of each package on the same batch
    and weights (the reference SGD recipe, lr `lr`)."""
    j_ecfg, t_ecfg, bank_np, arrs = _setup(kind)
    jb, tb = _batches(arrs)
    params = _params()
    tx = jtrain.make_optimizer(Config(), jlr.warmup_multifactor_schedule(lr, (10000,)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JTrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax.jit(j_make_train_step(JFlowNet(pred_flow=True, pred_mask=True), tx, j_ecfg,
                                      JTIC(**TICFG), "viz"))
    jstate, j_metrics, j_pose = jstep(jstate, jb, tuple(map(jnp.asarray, bank_np)))
    model = _port_model()
    state = TrainState(model, ttrain.make_optimizer(model.parameters(), TrainConfig(),
                                                    tlr.warmup_multifactor_schedule(lr, (10000,))))
    step = ttrain.make_train_step(t_ecfg, TrainIterConfig(**TICFG), "viz", device="cpu")
    state, t_metrics, t_pose = step(state, tb, bank_np)
    j_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    return (j_sd, {k: np.asarray(v) for k, v in j_metrics.items()}, np.asarray(j_pose), int(jstate.step),
            state, {k: v.numpy() for k, v in t_metrics.items()}, t_pose.numpy())


@pytest.mark.parametrize("kind", ["dense", "planes64"])
def test_train_step_matches_jax(kind):
    """A whole make_train_step of 2 inner iterations (forward, backward,
    SGD update, rollout guard, label refresh), on the dense scene and on
    the CSR scene rendered through csr_planes_raster (JAX: its planes64
    Pallas kernel, interpreted).  Per-iteration losses rtol 1e-4 (the
    second iteration runs on updated weights and a new pose); parameters
    after the step within 4 ulp of their magnitude plus 2% of the tensor's
    largest update (the second gradient is taken at poses ~1e-6 apart, so
    a pixel on an edge of the render, the zoom or the flow labels can
    differ; measured on the CPU: 0.3% dense, 0.8% planes64); final pose
    atol 1e-5."""
    j_sd, j_m, j_pose, j_step, state, t_m, t_pose = _train_both(kind)
    sd0 = state_dict_from_flax(_params())
    assert state.step == j_step == 2 and state.optimizer.count == 2
    assert set(t_m) == set(j_m) == {"pm_loss", "flow_loss", "mask_loss", "total", "raster_dropped"}
    for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
        assert t_m[key].shape == (2,) and np.isfinite(t_m[key]).all()
        np.testing.assert_allclose(t_m[key], j_m[key], rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(t_m["raster_dropped"], j_m["raster_dropped"])
    assert not t_m["raster_dropped"].any()
    moved = 0
    for name, p in state.model.state_dict().items():
        ref, p0 = j_sd[name].numpy(), sd0[name].numpy()
        delta = float(np.abs(ref - p0).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(ref).max()))) + 2e-2 * delta
        np.testing.assert_allclose(p.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        moved += delta > 0
    assert moved == len(j_sd)
    np.testing.assert_allclose(t_pose, j_pose, atol=1e-5, rtol=0)
    assert np.abs(t_pose - _setup(kind)[3]["pose_rendered"]).max() > 1e-4


def test_csr_planes64_step_renders_through_planes_kernel():
    """The planes64 scene's step used csr_planes_raster (the twin on the
    CPU, so no launch is counted) and its render equals the slots8 path's
    bit for bit."""
    _, t_ecfg, bank_np, arrs = _setup("planes64")
    meshes = MeshBuffers.gather(bank_np, arrs["class_index"], device="cpu")
    from deepim_tpu_torch.render.rasterizer import kernel_inputs, rasterize
    args = (meshes.vertices, meshes.colors, meshes.faces, meshes.face_valid, _t(arrs["pose_rendered"]),
            _t(K_MAT))
    assert [n for n, _ in kernel_inputs(*args, t_ecfg.raster, device="cpu")] == ["csr_planes_raster"]
    slots8 = dataclasses.replace(t_ecfg.raster, csr_kernel="slots8")
    for a, b in zip(rasterize(*args, t_ecfg.raster, device="cpu"), rasterize(*args, slots8, device="cpu")):
        assert torch.equal(a, b)


# --- engine helpers ----------------------------------------------------------


def test_mesh_buffers_gather_accepts_tensors():
    """MeshBuffers.gather indexes numpy arrays or tensors where they lie,
    with numpy or tensor class indices, and gives the same buffers."""
    _, _, bank_np, arrs = _setup("dense")
    cls = arrs["class_index"]
    ref = MeshBuffers.gather(bank_np, cls, device="cpu")
    for bank, idx in ((tuple(map(_t, bank_np)), _t(cls)), (dict(zip(("vertices", "colors", "faces",
                                                                      "face_valid"), map(_t, bank_np))),
                                                             cls.tolist())):
        got = MeshBuffers.gather(bank, idx, device="cpu")
        for a, b in zip(got, ref):
            assert (a is None and b is None) or torch.equal(a, b)
        assert got.normals is None and got.uv is None and got.textures is None


def test_train_batch_from_scene():
    """engine.scene.train_batch: box-filled observed mask, gt mask, gt
    and observed depth, the scene's poses, and points zero-padded past each mesh's real
    vertices with weight 0 (the 24-vertex cube, 162-vertex ico2)."""
    k = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
    sc = build_scene(2, 64, 64, k, num_iters=2, update_mask="box_gt", device="cpu")
    batch = train_batch(sc, k, 32)
    assert tuple(batch.points_model.shape) == (2, 32, 3)
    np.testing.assert_array_equal(batch.points_weights.sum(1).numpy(), [24, 32])
    assert (batch.points_model[0, 24:] == 0).all() and (batch.points_model[1].abs().sum(-1) > 0).all()
    np.testing.assert_array_equal(batch.mask_observed.numpy(), np.asarray(j_box_fill(jnp.asarray(sc.mask.numpy()))))
    assert torch.equal(batch.depth_gt_observed, sc.depth[:, 0]) and torch.equal(batch.depth_observed, sc.depth)
    np.testing.assert_array_equal(batch.pose_rendered.numpy(), sc.pose0)
    np.testing.assert_array_equal(batch.class_index.numpy(), sc.cls_idx)
