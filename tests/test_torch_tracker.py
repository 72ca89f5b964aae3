"""Parity of the port's video tracker (deepim_tpu_torch/engine/tracker.py,
tools/track_video.py) with the JAX package's on the CPU.

The matching network is tests/test_tracker.py's analytic centroid oracle,
ported to torch with the same arithmetic (its spatial sums are of integers,
exact in float32 in any order), on tests/test_tracker.py's 96x128 orbit
scene: the dense scene (a 320-face icosphere and a cube, 60 frames,
B = 2) and a CSR variant (a 5,120-face icosphere, 6 frames, the fewest
in which the sphere's silhouette enters another 8x64 tile: the JAX side
interprets its Pallas kernel, 16 frames took 109 s).  Both
packages get the same numpy frames, meshes and initial pose.  Tolerances:
per-frame poses 1e-4 (the refine tolerance of tests/test_torch_refine.py)
up to the first frame where a pixel changed side in one package only,
from there twice the JAX package's own gap when frame 0 is nudged by
ROUNDING_NUDGE, which may part no later than the port (see there);
dropped-pair counts equal; a real FlowNetDeepIM in fp32 (weights through
models/convert.py) 1e-4; the driver's bf16 default within 2x the JAX
package's own bf16-vs-fp32 gap, as tests/test_torch_bf16.py holds bf16."""
import dataclasses
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

import deepim_tpu.tools.track_video as j_track_video  # noqa: E402
from deepim_tpu.data.pairdb import load_gt_pairdb as j_load_gt_pairdb  # noqa: E402
from deepim_tpu.engine import MeshBuffers as JMeshBuffers  # noqa: E402
from deepim_tpu.engine import make_tracker as j_make_tracker  # noqa: E402
from deepim_tpu.engine import render_at_pose as j_render_at_pose  # noqa: E402
from deepim_tpu.engine.refine import tune_raster_for_bank as j_tune  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.tools.train_net import build_mesh_bank as j_build_mesh_bank  # noqa: E402
from deepim_tpu_torch.data.pairdb import load_gt_pairdb  # noqa: E402
from deepim_tpu_torch.engine import EngineConfig, MeshBuffers, make_tracker, track_video_sharded  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from deepim_tpu_torch.engine.train import TrainState  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM, state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.parallel import Mesh, make_mesh  # noqa: E402
from deepim_tpu_torch.render.mesh import MeshBank, make_icosphere, make_test_cube  # noqa: E402
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402
import deepim_tpu_torch.tools.track_video as t_track_video  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_mesh_bank  # noqa: E402
from deepim_tpu_torch.utils.avi import read_avi_index  # noqa: E402
from test_torch_eval import PREFIX, TEST_EPOCH, _write_yaml, devkit  # noqa: E402,F401
from test_tracker import ECFG as J_ECFG  # noqa: E402
from test_tracker import FX, FY, H, K_MAT, W, CentroidOracle, make_orbit  # noqa: E402

torch.set_num_threads(2)


class TorchCentroidOracle:
    """tests/test_tracker.py:CentroidOracle on the port's NCHW input: the
    untangled delta from the foreground centroid shift (vx, vy) and area
    ratio (vz) of the zoomed (observed, rendered) pair."""

    num_regressors = 1

    def __init__(self, gain: float = 0.8, fx: float = FX, fy: float = FY):
        self.gain, self.fx, self.fy = gain, fx, fy

    def __call__(self, x):
        fo = (x[:, 0:3].sum(1) > 0.02).float()
        fr = (x[:, 3:6].sum(1) > 0.02).float()
        h, w = fo.shape[1:]
        ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
        area_o = fo.sum((1, 2)).clamp(min=1.0)
        area_r = fr.sum((1, 2)).clamp(min=1.0)
        vx = self.gain * ((fo * xs).sum((1, 2)) / area_o - (fr * xs).sum((1, 2)) / area_r) / self.fx
        vy = self.gain * ((fo * ys).sum((1, 2)) / area_o - (fr * ys).sum((1, 2)) / area_r) / self.fy
        vz = self.gain * 0.5 * torch.log(area_o / area_r)
        rot = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=x.device).repeat(x.shape[0], 1)
        return {"rot": rot, "trans": torch.stack([vx, vy, vz], -1)}


def _port_ecfg(jecfg) -> EngineConfig:
    r = jecfg.raster
    return EngineConfig(height=jecfg.height, width=jecfg.width, update_mask=jecfg.update_mask,
                        num_iters=jecfg.num_iters,
                        raster=RasterConfig(height=r.height, width=r.width, tile_h=r.tile_h, tile_w=r.tile_w,
                                            max_faces_per_tile=r.max_faces_per_tile, chunk=r.chunk,
                                            znear=r.znear, zfar=r.zfar, bin_pairs=r.bin_pairs,
                                            csr_tiers=r.csr_tiers))


def _scene(kind: str):
    """(JAX ecfg, port ecfg, numpy bank arrays, frames (T, 2, 3, H, W),
    gt poses (T, 2, 3, 4)): the orbit rendered by the JAX package."""
    if kind == "dense":
        meshes, n_frames, jecfg = [make_icosphere(0.05, 2), make_test_cube(0.07)], 60, J_ECFG
    else:
        meshes, n_frames = [make_icosphere(0.05, 4), make_test_cube(0.07)], 6
        jecfg = dataclasses.replace(J_ECFG, raster=dataclasses.replace(J_ECFG.raster, use_pallas=True))
    bank = MeshBank.from_meshes(meshes, pad_multiple=64).arrays()
    if kind == "csr":
        jecfg = j_tune(jecfg, (bank["vertices"], bank["colors"], bank["faces"], bank["face_valid"]), K_MAT)
    poses_gt = make_orbit(n_frames, b=2)
    cls = np.tile([0, 1], n_frames)
    img, _, _ = j_render_at_pose(_jmeshes(bank, cls), jnp.asarray(poses_gt.reshape(-1, 3, 4)),
                                 jnp.asarray(K_MAT), jecfg)
    frames = np.asarray(img).reshape(n_frames, 2, 3, H, W)
    return jecfg, _port_ecfg(jecfg), bank, frames, poses_gt


_SCENES = {}


def scene(kind: str):
    if kind not in _SCENES:
        _SCENES[kind] = _scene(kind)
    return _SCENES[kind]


def _jmeshes(bank, cls):
    return JMeshBuffers.gather(tuple(jnp.asarray(bank[k]) for k in ("vertices", "colors", "faces", "face_valid")),
                               jnp.asarray(cls, jnp.int32))


def _pose0(poses_gt):
    """tests/test_tracker.py's perturbed frame-0 init."""
    pose0 = poses_gt[0].copy()
    pose0[:, 0, 3] += 0.015
    pose0[:, 1, 3] -= 0.01
    pose0[:, 2, 3] += 0.04
    return pose0


def _track_both(kind, n_frames=None, masks=None, init_iters=0, update_mask=None, raster=None):
    """Track the scene's first n_frames with both packages from the
    perturbed init; `update_mask` and `raster` (RasterConfig fields)
    override the scene's EngineConfig on both sides.  Returns the JAX
    result, the port's, and JAX's track from frame 0 nudged by
    ROUNDING_NUDGE (a callable, run only where the port departs)."""
    jecfg, tecfg, bank, frames, poses_gt = scene(kind)
    edit = {} if update_mask is None else {"update_mask": update_mask}
    jecfg = dataclasses.replace(jecfg, raster=dataclasses.replace(jecfg.raster, **(raster or {})), **edit)
    tecfg = dataclasses.replace(tecfg, raster=dataclasses.replace(tecfg.raster, **(raster or {})), **edit)
    frames = frames[:n_frames]
    pose0 = _pose0(poses_gt)
    j_track = jax.jit(j_make_tracker(CentroidOracle(), jecfg, iters_per_frame=2, init_iters=init_iters,
                                     with_stats=True))
    j_args = (jnp.asarray(frames), _jmeshes(bank, [0, 1]), jnp.asarray(K_MAT))
    j_masks = None if masks is None else jnp.asarray(masks)
    j_out = j_track(None, *j_args, jnp.asarray(pose0), j_masks)
    track = make_tracker(TorchCentroidOracle(), tecfg, iters_per_frame=2, init_iters=init_iters,
                         with_stats=True, device="cpu")
    t_out = track(frames, MeshBuffers.gather(bank, [0, 1], device="cpu"), torch.from_numpy(K_MAT),
                  torch.from_numpy(pose0), None if masks is None else torch.from_numpy(masks))

    def jax_nudged():
        nudged = pose0.copy()
        nudged[:, :, 3] += ROUNDING_NUDGE
        return np.asarray(j_track(None, *j_args, jnp.asarray(nudged), j_masks)[1])

    return j_out, t_out, jax_nudged


# A refinement step is discontinuous in the pose where a pixel changes side:
# CentroidOracle's 0.02 foreground threshold on the zoomed images, the hit
# test and the box of the rendered mask.  A rounding difference that moves
# one pixel across moves the pose by ~1e-4, and a free-running track keeps
# the difference: on the dense orbit one zoomed pixel crosses the threshold
# at frame 24 in one package and not the other (the zoomed images differ by
# up to 3e-3 of 255 from 1-ulp pose differences), and the tracks then differ
# by up to 2.3e-3.  JAX does the same against itself: with frame 0's
# translation nudged by ROUNDING_NUDGE (about 2 float32 ulps at the orbit's
# depth) its own track parts from frame 23 on by 2.0e-3.  So a track is held
# to POSE_TOL frame by frame up to its first departure, the first frame that
# leaves POSE_TOL; it may depart no earlier than JAX departs from itself
# under the nudge, and from there on it is held to twice JAX's own gap, the
# rule tests/test_torch_bf16.py applies to bf16 against fp32.
ROUNDING_NUDGE = 1e-7
POSE_TOL = 1e-4


def frame_errors(a, b) -> np.ndarray:
    """Per-frame max abs difference of two (T, ...) tracks."""
    return np.abs(np.asarray(a) - np.asarray(b)).reshape(len(a), -1).max(1)


def first_departure(err: np.ndarray, tol: float):
    """The first frame whose error exceeds tol, or None."""
    over = np.nonzero(err > tol)[0]
    return int(over[0]) if over.size else None


def _assert_track_equal(j_out, t_out, jax_nudged, record_property):
    """Per-frame poses within POSE_TOL of JAX's up to the first departure;
    the port departs no earlier than JAX does from itself under
    ROUNDING_NUDGE, and from the first departure on is within twice JAX's
    own gap there; the final pose is the last frame's; dropped counts
    equal."""
    (j_final, j_poses, j_st), (t_final, t_poses, t_st) = j_out, t_out
    assert tuple(t_poses.shape) == tuple(j_poses.shape)
    err = frame_errors(t_poses.numpy(), j_poses)
    record_property("max_pose_err", float(err.max()))
    dep = first_departure(err, POSE_TOL)
    if dep is not None:
        gap = frame_errors(jax_nudged(), j_poses)
        j_dep = first_departure(gap, POSE_TOL)
        record_property("departures_port_jax", (dep, j_dep))
        record_property("jax_rounding_gap", float(gap.max()))
        assert j_dep is not None and dep >= j_dep, f"port departs at frame {dep}, JAX from itself at {j_dep}"
        assert err[j_dep:].max() <= 2 * gap[j_dep:].max(), (err[j_dep:].max(), gap[j_dep:].max())
    np.testing.assert_array_equal(t_final.numpy(), t_poses[-1].numpy())
    assert int(t_st["raster_dropped"]) == int(j_st["raster_dropped"])
    return err


_PORT_TRACKS = {}


def _port_oracle_track(init: str) -> np.ndarray:
    """The port's track of the dense orbit with CentroidOracle from the
    perturbed init ('perturbed') or frame 0's gt pose ('gt')."""
    if init not in _PORT_TRACKS:
        _, tecfg, bank, frames, poses_gt = scene("dense")
        pose0 = _pose0(poses_gt) if init == "perturbed" else poses_gt[0]
        track = make_tracker(TorchCentroidOracle(), tecfg, iters_per_frame=2, device="cpu")
        _, poses = track(frames, MeshBuffers.gather(bank, [0, 1], device="cpu"), torch.from_numpy(K_MAT),
                         torch.from_numpy(pose0))
        _PORT_TRACKS[init] = poses.numpy()
    return _PORT_TRACKS[init]


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_tracker_equals_jax(kind, record_property):
    """The whole orbit (dense 60 frames, CSR 6) with CentroidOracle from
    the perturbed init: per-frame poses as _assert_track_equal holds them,
    no dropped pairs."""
    j_out, t_out, jax_nudged = _track_both(kind)
    _assert_track_equal(j_out, t_out, jax_nudged, record_property)
    assert int(t_out[2]["raster_dropped"]) == 0
    if kind == "dense":
        _PORT_TRACKS["perturbed"] = t_out[1].numpy()


def _box_masks(frames):
    """(T, B, 1, H, W) boxes around each frame's object."""
    fg = frames.sum(2, keepdims=True) > 0
    out = np.zeros(fg.shape, np.float32)
    for idx in np.ndindex(fg.shape[:2]):
        ys, xs = np.nonzero(fg[idx][0])
        out[idx][0, ys.min():ys.max() + 1, xs.min():xs.max() + 1] = 1.0
    return out


@pytest.mark.parametrize("case", ["init_iters", "masks_observed", "truncated"])
def test_tracker_options_equal_jax(case, record_property):
    """Each as _assert_track_equal holds it, dropped counts included:
    init_iters=2 (frame 0 locked on first, then refined again like every
    frame) and given observed masks (boxes around each frame's object),
    read under update_mask='init' (box_rendered rebuilds the box from the
    render and never reads them), each on the dense orbit's first 16
    frames; a forced truncation, a CSR budget of one tile a face, on the
    CSR orbit's first 4 frames."""
    kw = {"init_iters": {"kind": "dense", "n_frames": 16, "init_iters": 2},
          "masks_observed": {"kind": "dense", "n_frames": 16, "masks": _box_masks(scene("dense")[3][:16]),
                             "update_mask": "init"},
          "truncated": {"kind": "csr", "n_frames": 4, "raster": {"bin_pairs": 5120, "csr_tiers": ()}}}[case]
    j_out, t_out, jax_nudged = _track_both(**kw)
    _assert_track_equal(j_out, t_out, jax_nudged, record_property)
    dropped = int(t_out[2]["raster_dropped"])
    assert (dropped > 0) == (case == "truncated"), dropped


def _errors(poses, poses_gt):
    return np.linalg.norm(poses[..., 3] - poses_gt[..., 3], axis=-1)


def test_tracking_error_stays_bounded():
    """tests/test_tracker.py's bounded-error test on the port: from the
    perturbed init the track converges and stays locked over 60 frames."""
    poses_gt = scene("dense")[4]
    err = _errors(_port_oracle_track("perturbed"), poses_gt)
    assert err[0].max() < 0.05
    assert err[5:].max() < 0.03, f"tracking lost: max err {err[5:].max():.4f}"
    assert err[-10:].mean() < 0.015
    assert err[-10:].mean() < err[5:15].mean() + 0.005


def test_tracking_beats_static_init():
    """tests/test_tracker.py's propagation test on the port: re-using frame
    0's pose for every frame lets the object escape; tracking keeps it."""
    poses_gt = scene("dense")[4]
    err_tracked = _errors(_port_oracle_track("gt"), poses_gt)
    err_static = _errors(np.broadcast_to(poses_gt[0], poses_gt.shape), poses_gt)
    assert err_tracked[10:].mean() < 0.5 * err_static[10:].mean()


def test_track_video_sharded():
    """With mesh=None it is make_tracker's track, and so it is, bit for
    bit, over a parallel.Mesh of one rank (a process with no process
    group); videos that do not split over the mesh's ranks raise.  The
    sharded track over 2 ranks is tests/test_torch_parallel.py's."""
    _, tecfg, bank, frames, poses_gt = scene("dense")
    args = (frames[:3], MeshBuffers.gather(bank, [0, 1], device="cpu"), torch.from_numpy(K_MAT),
            torch.from_numpy(poses_gt[0]))
    final, poses = track_video_sharded(TorchCentroidOracle(), *args, tecfg, iters_per_frame=2, device="cpu")
    final2, poses2 = make_tracker(TorchCentroidOracle(), tecfg, 2, device="cpu")(*args)
    assert torch.equal(poses, poses2) and torch.equal(final, final2)
    final3, poses3 = track_video_sharded(TorchCentroidOracle(), *args, tecfg, mesh=make_mesh(device="cpu"),
                                         iters_per_frame=2)
    assert torch.equal(poses3, poses) and torch.equal(final3, final)
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        track_video_sharded(TorchCentroidOracle(), *args, tecfg, mesh=Mesh(0, 3, torch.device("cpu")))


# --- a real network, and the driver --------------------------------------

K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _fast_weights(hw):
    """FAST_TEST network params (numpy) with a random nonzero translation
    head, and the port's fp32 network loaded from them."""
    params = JFlowNet(pred_flow=False, pred_mask=False).init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    model = FlowNetDeepIM(input_hw=hw, pred_flow=False, pred_mask=False, device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    return params, model.eval()


def test_tracker_flownet_fp32_equals_jax(record_property):
    """A FlowNetDeepIM (FAST_TEST: encoder and SE(3) head) in fp32, the
    same weights on both sides, tracking a 64x64 orbit for 8 frames x 2
    iterations: per-frame poses within 1e-4, no dropped pairs."""
    from deepim_tpu.engine import EngineConfig as JEngineConfig
    from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig

    raster = dict(height=64, width=64, tile_h=16, tile_w=16, max_faces_per_tile=128, chunk=16, znear=0.05,
                  zfar=10.0)
    jecfg = JEngineConfig(height=64, width=64, raster=JRasterConfig(**raster), num_iters=2)
    tecfg = EngineConfig(height=64, width=64, raster=RasterConfig(**raster), num_iters=2)
    bank = MeshBank.from_meshes([make_icosphere(0.05, 2), make_test_cube(0.07)], pad_multiple=64).arrays()
    poses_gt = make_orbit(8, b=2)
    img, _, _ = j_render_at_pose(_jmeshes(bank, np.tile([0, 1], 8)), jnp.asarray(poses_gt.reshape(-1, 3, 4)),
                                 jnp.asarray(K64), jecfg)
    frames = np.asarray(img).reshape(8, 2, 3, 64, 64)
    pose0 = _pose0(poses_gt)
    params, model = _fast_weights((64, 64))
    j_track = jax.jit(j_make_tracker(JFlowNet(pred_flow=False, pred_mask=False), jecfg, 2, with_stats=True))
    j_out = j_track(params, jnp.asarray(frames), _jmeshes(bank, [0, 1]), jnp.asarray(K64), jnp.asarray(pose0))
    with torch.no_grad():
        t_out = make_tracker(model, tecfg, 2, with_stats=True, device="cpu")(
            frames, MeshBuffers.gather(bank, [0, 1], device="cpu"), torch.from_numpy(K64), torch.from_numpy(pose0))
    err = float(np.abs(t_out[1].numpy() - np.asarray(j_out[1])).max())
    record_property("max_pose_err", err)
    assert err <= POSE_TOL, err
    assert np.abs(t_out[1].numpy()[0] - pose0).max() > 1e-4  # the network moved the pose
    assert int(t_out[2]["raster_dropped"]) == int(j_out[2]["raster_dropped"]) == 0


def _driver_cfgs(devkit_path):
    """The eval devkit's config with the FAST_TEST heads only (a real
    network, and the cheapest JAX compile)."""
    from deepim_tpu.config import Config as JConfig
    from deepim_tpu.config import update_config_dict as j_update
    from deepim_tpu_torch.config import Config, update_config_dict
    from test_torch_eval import _cfg_dict

    d = _cfg_dict(devkit_path)
    d["network"].update(PRED_FLOW=False, PRED_MASK=False)
    return j_update(JConfig(), d), update_config_dict(Config(), d)


def _sequences(devkit_path):
    jc, tc = _driver_cfgs(devkit_path)
    j_db, j_pairdb = j_load_gt_pairdb(jc, "LM6D_REFINE", "val_cube", "cube", devkit_path, devkit_path)
    t_db, t_pairdb = load_gt_pairdb(tc, "LM6D_REFINE", "val_cube", "cube", devkit_path, devkit_path)
    return jc, tc, (j_db, j_pairdb), (t_db, t_pairdb)


def test_track_pairdb_sequence_equals_jax(devkit, record_property):
    """track_pairdb_sequence on the 64x64 devkit's cube sequence (5
    frames, 2 iterations each), the same FAST_TEST weights on both sides:
    fp32 poses and errors within 1e-4; the bf16 default (networks bf16, the
    CPU's zoom fp32 in both packages) within twice JAX's own bf16-vs-fp32
    gap; no dropped pairs."""
    jc, tc, (j_db, j_pairdb), (t_db, t_pairdb) = _sequences(devkit)
    params, model = _fast_weights((64, 64))
    j_bank = j_build_mesh_bank(jc)
    t_bank = build_mesh_bank(tc)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        out["jax", name] = j_track_video.track_pairdb_sequence(
            jc, params, JFlowNet(pred_flow=False, pred_mask=False, dtype=jdt), j_db, j_pairdb, j_bank, 2)
        net = FlowNetDeepIM(input_hw=(64, 64), pred_flow=False, pred_mask=False, dtype=dtype, device="cpu").eval()
        net.load_state_dict(model.state_dict())
        with torch.no_grad():
            out["port", name] = t_track_video.track_pairdb_sequence(tc, net, t_db, t_pairdb, t_bank, 2, device="cpu")
    (jp, jr, jt), (tp, tr, tt, run) = out["jax", "f32"], out["port", "f32"]
    assert tp.shape == (5, 3, 4) and run["frames"] == 5 and run["raster_dropped"] == 0
    assert run["decode_s"] > 0 and run["track_s"] > 0
    err = float(np.abs(tp - jp).max())
    record_property("f32_max_pose_err", err)
    assert err <= POSE_TOL, err
    np.testing.assert_allclose(tt, jt, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(tr, jr, atol=1e-2, rtol=0)  # degrees
    j16, t16 = out["jax", "bf16"][0], out["port", "bf16"][0]
    gap = float(np.abs(j16 - jp).max())
    diff = float(np.abs(t16 - j16).max())
    record_property("bf16_err_over_jax_gap", diff / gap)
    assert 0 < gap and diff <= 2 * gap, (diff, gap)


def _write_cfg(devkit_path, tmp_path) -> str:
    from test_torch_eval import _cfg_dict

    d = _cfg_dict(devkit_path)
    d["output_path"] = str(tmp_path / "out")
    cfg_file = tmp_path / "cfg.yaml"
    _write_yaml(cfg_file, d)
    return str(cfg_file)


def test_track_video_main(devkit, tmp_path):
    """The CLI with --device cpu, a saved checkpoint and --out: bf16
    network from the checkpoint (equal to track_pairdb_sequence with that
    network), the overlay AVI read back by cv2 (5 frames of 64x64 at 10
    fps, the silhouette edge green), the stage seconds reported; a
    non-.avi --out raises before any work."""
    import cv2

    from deepim_tpu_torch.config import load_config
    from deepim_tpu_torch.tools.train_net import build_model

    cfg_file = _write_cfg(devkit, tmp_path)
    cfg = load_config(cfg_file)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        model.trans.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    prefix = str(tmp_path / "ckpt" / PREFIX)
    save_checkpoint(prefix, TEST_EPOCH, TrainState(model, None))
    out = tmp_path / "vid" / "track.avi"
    res = t_track_video.main(["--cfg", cfg_file, "--cls", "sphere", "--ckpt-prefix", prefix, "--out", str(out),
                              "--device", "cpu"])
    assert res["poses"].shape == (5, 3, 4) and np.isfinite(res["poses"]).all()
    run = res["run"]
    for key in ("decode_s", "track_s", "overlay_s"):
        assert run[key] > 0, key
    assert "images" not in run and run["raster_dropped"] == 0 and run["video"]["frames"] == 5

    bf16 = build_model(cfg, device="cpu")
    bf16.load_state_dict(model.state_dict())
    db, pairdb = load_gt_pairdb(cfg, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit)
    with torch.no_grad():
        poses = t_track_video.track_pairdb_sequence(cfg, bf16, db, pairdb, build_mesh_bank(cfg), 2,
                                                    device="cpu")[0]
    np.testing.assert_array_equal(res["poses"], poses)

    idx = read_avi_index(str(out))
    assert (idx["frames"], idx["width"], idx["height"], idx["fps"], idx["fourcc"]) == (5, 64, 64, 10.0, "MPNG")
    cap = cv2.VideoCapture(str(out))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr[:, :, ::-1])
    assert len(frames) == 5 and cap.get(cv2.CAP_PROP_FPS) == 10.0
    green = [(f == (0, 255, 0)).all(-1).sum() for f in frames]
    assert min(green) > 0, green

    with pytest.raises(ValueError, match=r"\.avi"):
        t_track_video.main(["--cfg", cfg_file, "--cls", "sphere", "--out", str(tmp_path / "t.mp4"),
                            "--device", "cpu"])


def test_track_video_cli_needs_cuda(devkit, tmp_path):
    """Without --device cpu, on a host with no CUDA device, the CLI raises
    instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA refusal needs a host without a CUDA device")
    cmd = [sys.executable, "-m", "deepim_tpu_torch.tools.track_video", "--cfg", _write_cfg(devkit, tmp_path),
           "--cls", "cube"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode != 0 and "torch.cuda.is_available() is False" in res.stderr
