"""Parity of the port's data parallelism (deepim_tpu_torch/parallel/, DDP in
tools/train_net.py, track_video_sharded(mesh=)) with the JAX package's dp
mesh on the CPU.

The JAX side runs on make_mesh(2) of tests/conftest.py's 8 virtual
devices.  The port's side runs as 2 gloo ranks started by
`python -m torch.distributed.run --standalone` (its own free port), each
with 2 threads, in tests/_torch_dp_worker.py: one launch for the engine's
pieces, one for the drivers, each rank writing one .npz.  Inputs are the
same numpy arrays and weights (models/convert.py:state_dict_from_flax) on
both sides, fp32 networks.

Tolerances: shard_pytree_batch's rows equal the JAX arrays' addressable
shards exactly; the ranks' parameters after a DDP step or epoch equal
bit for bit; a train step's or an epoch's per-iteration losses to rtol
1e-3 and parameters within 4 ulp of their magnitude plus 2% of the
tensor's largest update (tests/test_torch_train.py's rule), learning rates
equal; refine_dp's poses to atol 1e-4 (tests/test_torch_refine.py's
2-iteration tolerance); the sharded track frame by frame to 1e-4 up to its
first departure, then as tests/test_torch_tracker.py holds a track."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.tools.train_net as j_train_net  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import TrainIterConfig as JTIC  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.engine import Observation as JObservation  # noqa: E402
from deepim_tpu.engine import TrainBatch as JTrainBatch  # noqa: E402
from deepim_tpu.engine import TrainState as JTrainState  # noqa: E402
from deepim_tpu.engine import make_train_step as j_make_train_step  # noqa: E402
from deepim_tpu.engine import refine as j_refine  # noqa: E402
from deepim_tpu.engine import track_video_sharded as j_track_video_sharded  # noqa: E402
from deepim_tpu.engine.lr_schedule import warmup_multifactor_schedule as j_schedule  # noqa: E402
from deepim_tpu.engine.train import make_optimizer as j_make_optimizer  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu.parallel import jit_refine_dp, jit_train_step_dp  # noqa: E402
from deepim_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from deepim_tpu.parallel import replicate_pytree as j_replicate  # noqa: E402
from deepim_tpu.parallel import shard_pytree_batch as j_shard  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.device import resolve_device  # noqa: E402
from deepim_tpu_torch.engine import TrainBatch  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.parallel import Mesh, find_unused_parameters, initialize_distributed  # noqa: E402
from deepim_tpu_torch.parallel import make_mesh, shard_pytree_batch  # noqa: E402
from test_parallel import ECFG as J_ECFG  # noqa: E402
from test_parallel import K_MAT as K64  # noqa: E402
from test_parallel import build as build_scene64  # noqa: E402
from test_torch_eval import _write_yaml  # noqa: E402
from test_torch_tracker import POSE_TOL, ROUNDING_NUDGE, _jmeshes, _pose0, first_departure  # noqa: E402
from test_torch_tracker import frame_errors, scene  # noqa: E402
from test_torch_train_driver import _J_BUILD_MODEL, PREFIX, _cfg_dict, _recorders, devkit  # noqa: E402,F401
from test_tracker import K_MAT as K_TRACK  # noqa: E402
from test_tracker import CentroidOracle  # noqa: E402

torch.set_num_threads(2)

WORKER = TESTS / "_torch_dp_worker.py"
B = 4                   # global batch of the engine checks: 2 rows a rank
TRACK_T = 16            # frames of the sharded track (the dense orbit's first)
LAUNCH_TIMEOUT = 600    # seconds for one torch.distributed.run launch
TICFG = dict(SE3_PM_LOSS=True, LW_PM=0.1, NUM_3D_SAMPLE=16, LW_FLOW=0.25, LW_MASK=0.03)
LOSSES = ("pm_loss", "flow_loss", "mask_loss", "total")


def _launch(mode: str, work: Path) -> list:
    """Run the worker on 2 gloo ranks; both ranks are killed if the launch
    outlives LAUNCH_TIMEOUT.  Returns each rank's outputs."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", str(WORKER),
           mode, str(work)]
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=str(work), start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, f"{mode} ranks failed:\n{out[-6000:]}"
    return [dict(np.load(work / f"{mode}_rank{r}.npz")) for r in range(2)]


def _weights(hw):
    """The full network's JAX parameters (numpy) with a random nonzero
    translation head, so refinement moves the pose."""
    params = JFlowNet(pred_flow=True, pred_mask=True).init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    return params


def _batch_arrays(b: int):
    """tests/test_parallel.py's 64x64 cube scene as TrainBatch arrays, and
    the bank."""
    bank, cls, meshes, pose_gt, pose0, img, depth, mask = build_scene64(np.random.RandomState(42), b)
    arrs = dict(image_observed=np.asarray(img), mask_observed=np.asarray(j_box_fill(mask)),
                mask_gt_observed=np.asarray(mask), depth_gt_observed=np.asarray(depth[:, 0]),
                pose_rendered=pose0, pose_observed=pose_gt, class_index=np.asarray(cls),
                points_model=np.asarray(meshes.vertices[:, :16]), points_weights=np.ones((b, 16), np.float32),
                k=K64)
    return arrs, tuple(np.asarray(x) for x in bank)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """The JAX dp step, refinement and track on make_mesh(2), and the
    port's on 2 gloo ranks, from the same inputs."""
    work = tmp_path_factory.mktemp("dp_engine")
    arrs, bank = _batch_arrays(B)
    params = _weights((64, 64))
    _, _, tbank, frames, poses_gt = scene("dense")
    frames, pose0 = frames[:TRACK_T], _pose0(poses_gt)
    np.savez(work / "engine_in.npz", **arrs, **{f"w/{k}": v.numpy() for k, v in state_dict_from_flax(params).items()},
             **{f"bank_{k}": v for k, v in zip(("vertices", "colors", "faces", "face_valid"), bank)},
             **{f"track_bank_{k}": v for k, v in tbank.items()}, track_frames=frames, track_k=K_TRACK,
             track_pose0=pose0)
    ranks = _launch("engine", work)

    mesh = j_make_mesh(2)
    model = JFlowNet(pred_flow=True, pred_mask=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = j_make_optimizer(JConfig(), j_schedule(1e-4, (1000,)))
    state = j_replicate(JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32)), mesh)
    batch = j_shard(JTrainBatch(**{k: jnp.asarray(v) for k, v in arrs.items()}), mesh)
    bank_d = j_replicate(tuple(map(jnp.asarray, bank)), mesh)
    step = jit_train_step_dp(j_make_train_step(model, tx, J_ECFG, JTIC(**TICFG), "viz"), mesh, state, batch, bank_d)
    state, metrics, pose = step(state, batch, bank_d)

    obs = JObservation(image_observed=jnp.asarray(arrs["image_observed"]),
                       mask_observed=jnp.asarray(arrs["mask_observed"]), mask_gt_observed=None,
                       depth_observed=None, k=jnp.asarray(K64))
    jmeshes = j_shard(_jmeshes({k: v for k, v in zip(("vertices", "colors", "faces", "face_valid"), bank)},
                               arrs["class_index"]), mesh)
    obs_d, p_d = j_shard(obs, mesh), j_replicate(jp, mesh)
    prefine = jit_refine_dp(lambda p, o, m, q: j_refine(p, model, o, m, q, J_ECFG), mesh, p_d, obs_d, jmeshes)
    r_final, r_poses = prefine(p_d, obs_d, jmeshes, j_shard(jnp.asarray(arrs["pose_rendered"]), mesh))

    track_args = (jnp.asarray(frames), _jmeshes(tbank, [0, 1]), K_TRACK)
    jecfg = scene("dense")[0]

    def jax_track(p0):
        return j_track_video_sharded(None, CentroidOracle(), *track_args, jnp.asarray(p0), jecfg, mesh=mesh,
                                     iters_per_frame=2)

    t_final, t_poses = jax_track(pose0)
    nudged = pose0.copy()
    nudged[:, :, 3] += ROUNDING_NUDGE
    return {
        "ranks": ranks, "init": state_dict_from_flax(params),
        "jax": {"params": state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params)),
                "metrics": {k: np.asarray(v) for k, v in metrics.items()}, "pose": np.asarray(pose),
                "step": int(state.step), "refine_final": np.asarray(r_final), "refine_poses": np.asarray(r_poses),
                "track_final": np.asarray(t_final), "track_poses": np.asarray(t_poses),
                "track_nudged": lambda: np.asarray(jax_track(nudged)[1])},
    }


def _assert_params_close(port: dict, ref: dict, init: dict, what: str):
    """tests/test_torch_train.py's rule: within 4 ulp of the tensor's
    magnitude plus 2% of its largest update; every tensor moved."""
    moved = 0
    for name, p0 in init.items():
        p, r, p0 = np.asarray(port[name]), np.asarray(ref[name]), np.asarray(p0)
        delta = float(np.abs(r - p0).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(r).max()))) + 2e-2 * delta
        np.testing.assert_allclose(p, r, atol=atol, rtol=0, err_msg=f"{what}: {name}")
        moved += delta > 0
    assert moved == len(init), what


def _rank_params(out: dict, tag: str) -> dict:
    return {k[len(tag) + 2:]: v for k, v in out.items() if k.startswith(tag + "p/")}


# -- sharding rules and refusals ---------------------------------------------------

@pytest.mark.parametrize("b", [4, 3])
def test_shard_pytree_batch_matches_jax_shards(b):
    """On a TrainBatch whose leaves divide over 2 ranks (b 4: each rank its
    2 rows; k (3, 3) whole) and one whose leaves do not (b 3: every leaf
    whole), rank r's leaves equal the JAX arrays' addressable shard on
    device r of make_mesh(2), exactly."""
    arrs, _ = _batch_arrays(b)
    jmesh = j_make_mesh(2)
    jb = j_shard(JTrainBatch(**{k: jnp.asarray(v) for k, v in arrs.items()}), jmesh)
    tb = TrainBatch(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})
    for r, dev in enumerate(jmesh.devices):
        local = shard_pytree_batch(tb, Mesh(r, 2, torch.device("cpu")))
        for name in TrainBatch._fields:
            j_leaf, t_leaf = getattr(jb, name), getattr(local, name)
            if j_leaf is None:
                assert t_leaf is None, name
                continue
            shard, = [s.data for s in j_leaf.addressable_shards if s.device == dev]
            assert tuple(t_leaf.shape) == shard.shape, name
            np.testing.assert_array_equal(t_leaf.numpy(), np.asarray(shard), err_msg=f"rank {r} {name}")
        rows = 2 if b == 4 else b
        assert local.image_observed.shape[0] == rows and local.k.shape == (3, 3)


def test_make_mesh_in_one_process():
    """Without a process group the mesh is this process alone; n_devices
    must be the world size."""
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
    assert make_mesh(1, device="cpu") == mesh
    mesh.barrier()
    with pytest.raises(ValueError, match="one device each"):
        make_mesh(2, device="cpu")


@pytest.fixture
def launcher_env(monkeypatch):
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(key, value)
    return monkeypatch


@pytest.mark.parametrize("case", ["nccl_on_cpu", "cuda_missing", "ranks_over_cards", "no_launcher"])
def test_initialize_distributed_refuses(launcher_env, case):
    """NCCL on the CPU, CUDA asked for where there is none, and NCCL with
    more ranks on the host than cards each raise before any group exists
    (no switch to gloo, no shared card); without the launcher's
    environment it is a no-op."""
    mp = launcher_env
    if case == "nccl_on_cpu":
        with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
            initialize_distributed(backend="nccl", device="cpu")
    elif case == "cuda_missing":
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            initialize_distributed(backend="nccl")
    elif case == "ranks_over_cards":
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        mp.setattr(torch.cuda, "set_device", lambda i: pytest.fail("set_device before the refusal"))
        for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
            mp.setenv(key, value)
        with pytest.raises(RuntimeError, match="one card per rank"):
            initialize_distributed()
    else:
        mp.delenv("MASTER_ADDR")
        assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_resolve_device_carries_the_current_index(monkeypatch):
    """resolve_device('cuda') is the current card with its index (CUDA
    patched in where there is none); an explicit index and the CPU pass
    through; without CUDA, 'cuda' raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            resolve_device("cuda")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(torch.device("cuda")).index == 3
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("edit,expect", [
    ({}, False),
    ({"train_iter": {"LW_FLOW": 0.0}}, True),
    ({"train_iter": {"LW_MASK": 0.0}}, True),
    ({"network": {"PRED_FLOW": False, "PRED_MASK": False}, "train_iter": {"LW_FLOW": 0.0, "LW_MASK": 0.0}}, False),
    ({"train_iter": {"SE3_PM_LOSS": False}}, True),
    ({"network": {"REGRESSOR_NUM": 2, "ROT_TYPE": "EULER"}}, False),
])
def test_find_unused_parameters_rule(devkit, edit, expect):
    """DDP looks for unused parameters only where a head can go without a
    gradient: a flow or mask head whose loss weight is 0, or no SE(3)
    loss.  The recipe's heads and per-class EULER heads (one Linear,
    gathered) never do."""
    d = _cfg_dict(devkit)
    for key, value in edit.items():
        d[key] = {**d[key], **value}
    assert find_unused_parameters(update_config_dict(Config(), d)) is expect


# -- the engine on 2 ranks against make_mesh(2) ---------------------------------------

def test_train_step_dp_matches_jax(engine):
    """train_step_dp on 2 ranks (2 rows each) against jit_train_step_dp on
    make_mesh(2): the ranks' parameters bit-equal, the rank-averaged
    metrics to rtol 1e-3 per inner iteration, parameters by the rule,
    each rank's pose rows JAX's, dropped pairs summed (none)."""
    r0, r1 = engine["ranks"]
    j = engine["jax"]
    p0, p1 = _rank_params(r0, "dp/"), _rank_params(r1, "dp/")
    assert p0.keys() == engine["init"].keys()
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
    for out in (r0, r1):
        assert int(out["dp_step"]) == int(out["dp_count"]) == j["step"] == 2
        for key in LOSSES:
            assert out[f"dp/m/{key}"].shape == (2,)
            np.testing.assert_allclose(out[f"dp/m/{key}"], j["metrics"][key], rtol=1e-3, err_msg=key)
        np.testing.assert_array_equal(out["dp/m/raster_dropped"], j["metrics"]["raster_dropped"])
        np.testing.assert_array_equal(out["dp/m/raster_dropped"], 0)
    _assert_params_close(p0, j["params"], engine["init"], "DDP vs JAX dp")
    np.testing.assert_allclose(np.concatenate([r0["dp_pose"], r1["dp_pose"]]), j["pose"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(r0["dp_pose_all"], r1["dp_pose_all"])
    np.testing.assert_array_equal(r0["dp_pose_all"], np.concatenate([r0["dp_pose"], r1["dp_pose"]]))


def test_train_step_dp_equals_one_process_step(engine):
    """DDP over 2 ranks against the port's own step on the whole batch in
    one process: metrics to rtol 1e-3, parameters by the rule, poses to
    1e-5."""
    r0, r1 = engine["ranks"]
    for key in LOSSES:
        np.testing.assert_allclose(r0[f"dp/m/{key}"], r0[f"one/m/{key}"], rtol=1e-3, err_msg=key)
    _assert_params_close(_rank_params(r0, "dp/"), _rank_params(r0, "one/"), engine["init"], "DDP vs one process")
    np.testing.assert_allclose(r0["dp_pose_all"], r0["one_pose"], atol=1e-5, rtol=0)


def test_refine_dp_matches_jax(engine):
    """refine_dp (2 iterations, 2 rows a rank, the whole batch gathered on
    every rank) against jit_refine_dp: pose_final and poses to 1e-4."""
    j = engine["jax"]
    for out in engine["ranks"]:
        assert out["refine_poses"].shape == (2, B, 3, 4)
        np.testing.assert_allclose(out["refine_final"], j["refine_final"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(out["refine_poses"], j["refine_poses"], atol=1e-4, rtol=0)
    assert np.abs(j["refine_final"] - _batch_arrays(B)[0]["pose_rendered"]).max() > 1e-4


def test_track_video_sharded_matches_jax(engine, record_property):
    """track_video_sharded(mesh=) over 2 ranks, one video each (the dense
    orbit's first TRACK_T frames, the centroid oracle, 2 iterations a
    frame) against JAX's on make_mesh(2): every frame within POSE_TOL up
    to the first departure, which may come no earlier than JAX's own under
    ROUNDING_NUDGE, then within twice JAX's gap; both ranks hold every
    video."""
    j = engine["jax"]
    r0, r1 = engine["ranks"]
    np.testing.assert_array_equal(r0["track_poses"], r1["track_poses"])
    assert r0["track_poses"].shape == (TRACK_T, 2, 3, 4)
    np.testing.assert_array_equal(r0["track_final"], r0["track_poses"][-1])
    err = frame_errors(r0["track_poses"], j["track_poses"])
    record_property("max_pose_err", float(err.max()))
    dep = first_departure(err, POSE_TOL)
    if dep is not None:
        gap = frame_errors(j["track_nudged"](), j["track_poses"])
        j_dep = first_departure(gap, POSE_TOL)
        assert j_dep is not None and dep >= j_dep, (dep, j_dep)
        assert err[j_dep:].max() <= 2 * gap[j_dep:].max()


def test_replicate_and_gather_on_two_ranks(engine):
    """replicate_pytree gives rank 0's leaves everywhere (numpy and tensor
    leaves); gather_batch concatenates in rank order along dim 0 or 1."""
    for out in engine["ranks"]:
        np.testing.assert_array_equal(out["replicated_a"], np.zeros((2, 3), np.float32))
        np.testing.assert_array_equal(out["replicated_b"], [5])
        np.testing.assert_array_equal(out["gathered"], [[0.0, 0.0], [1.0, 1.0]])
        np.testing.assert_array_equal(out["gathered_dim1"], np.tile([[0.0, 1.0]], (3, 1)))


# -- the drivers on 2 ranks against JAX's train_net(n_devices=2) --------------------------

@pytest.fixture(scope="module")
def driver(devkit, tmp_path_factory):
    """One epoch of train_net on 2 gloo ranks (BATCH_PAIRS 2: a global batch
    of 4, 4 steps x 2 inner iterations) and of JAX's train_net(n_devices=2)
    from the same fp32 weights; after it, the ranks run tools/train_test
    from a YAML file."""
    import json

    work = tmp_path_factory.mktemp("dp_driver")
    # TENSORBOARD_LOG: the recorders stand in for both TensorBoard loggers
    # and keep each step's learning rate (the port's on rank 0 alone).
    d = _cfg_dict(devkit, {"BATCH_PAIRS": 2, "TENSORBOARD_LOG": True})
    d["output_path"] = str(work / "out")
    (work / "driver_cfg.json").write_text(json.dumps(d))
    jc = j_update(JConfig(), d)
    _, params = _J_BUILD_MODEL(jc, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    init = state_dict_from_flax(params)
    np.savez(work / "driver_in.npz", **{f"w/{k}": v.numpy() for k, v in init.items()})
    front = _cfg_dict(devkit, {"BATCH_PAIRS": 2, "model_prefix": "cli_dp", "warmup_lr": 0.0})
    front["dataset"] = {**front["dataset"], "dataset": "LM6D_REFINE", "image_set": "train_"}
    front["output_path"] = str(work / "front")
    _write_yaml(work / "front_door.yaml", front)
    ranks = _launch("driver", work)

    store = {}
    with pytest.MonkeyPatch.context() as mp:
        speedo, tb = _recorders(store)
        mp.setattr(j_train_net, "Speedometer", speedo)
        mp.setattr(j_train_net, "TBLogger", tb)
        mp.setattr(j_train_net, "build_model", lambda cfg: _J_BUILD_MODEL(cfg, dtype=jnp.float32))
        state = j_train_net.train_net(jc, output_dir=str(work / "jax"), n_devices=2, init_params=params)
    store["params"] = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    store["step"] = int(state.step)
    return {"ranks": ranks, "jax": store, "init": init, "work": work}


def test_train_net_dp_matches_jax(driver):
    """One epoch on 2 ranks against JAX's train_net(n_devices=2): equal
    learning rates per step, losses per inner iteration (averaged over
    the ranks) to rtol 1e-3, parameters by the rule, global samples."""
    r0, _ = driver["ranks"]
    j = driver["jax"]
    assert int(r0["step"]) == int(r0["count"]) == j["step"] == 8
    assert int(r0["samples"]) == 16
    assert [tuple(x) for x in r0["lr"]] == j["lr"] and [int(s) for s, _ in r0["lr"]] == [2, 4, 6, 8]
    assert len(j["metrics"]) == 4
    for step, jm in enumerate(j["metrics"]):
        for key in LOSSES:
            for it in range(2):
                np.testing.assert_allclose(r0[f"m/{key}"][step, it], jm[f"{key}/iter{it}"], rtol=1e-3,
                                           err_msg=f"step {step} {key}/iter{it}")
        assert r0["m/raster_dropped"][step].sum() == jm["raster_dropped"] == 0
    _assert_params_close(_rank_params(r0, ""), j["params"], driver["init"], "train_net DDP vs JAX")


def test_train_net_dp_ranks_agree_and_rank0_writes(driver):
    """Both ranks end the epoch with bit-equal parameters and the same
    rank-averaged metrics; rank 0 alone heard the Speedometer and the
    TensorBoard logger, created the run directory's one log file and wrote
    the one checkpoint."""
    r0, r1 = driver["ranks"]
    p0, p1 = _rank_params(r0, ""), _rank_params(r1, "")
    assert p0.keys() == p1.keys() == driver["init"].keys()
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
    for key in LOSSES:
        np.testing.assert_array_equal(r0[f"m/{key}"], r1[f"m/{key}"], err_msg=key)
    assert list(r0["heard"]) == [0, 1, 2, 3] and r1["heard"].size == 0 and r1["lr"].size == 0
    run = driver["work"] / "out" / PREFIX / "train_+train_"
    files = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
    assert len([f for f in files if f.startswith("log_")]) == 1, files
    assert [f for f in files if not f.startswith("log_")] == [f"{PREFIX}_ckpt/1"], files


def test_train_test_front_door_on_two_ranks(driver):
    """tools/train_test.main on 2 ranks of torch.distributed.run (gloo with
    --device cpu): both ranks train, rank 0 tests the trained network (4
    pairs) and the other rank returns None; rank 0 alone wrote the
    checkpoint, the log and the test's results."""
    r0, r1 = driver["ranks"]
    assert not bool(r0["front_door_none"]) and int(r0["front_door_pairs"]) == 4
    assert bool(r1["front_door_none"])
    run = driver["work"] / "front" / "cli_dp"
    assert (run / "train_" / "cli_dp_ckpt" / "1").exists()
    assert (run / "val_" / "results_pose.pkl").exists()
    assert len(list((run / "train_").glob("log_*.txt"))) == 1
