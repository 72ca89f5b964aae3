"""Rank process for tests/test_torch_parallel.py: the port's data-parallel
pieces on 2 gloo ranks of the CPU, started by

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/_torch_dp_worker.py <engine|driver> <work dir>

Each rank reads what the test wrote into <work dir> and writes
<mode>_rank<r>.npz there.

engine: train_step_dp on tests/test_parallel.py's 64x64 scene (the global
  batch split by shard_pytree_batch), and rank 0's one-process step on the
  whole batch; refine_dp; track_video_sharded(mesh=) with the centroid
  oracle on tests/test_torch_tracker.py's dense orbit; replicate_pytree and
  gather_batch.
driver: train_net for one epoch from the test's weights (fp32 networks;
  every step's learning rate and metrics recorded on rank 0), then
  tools/train_test.main from a YAML file (rank 0 tests, the other rank
  returns None).

Each rank joins the group once: a default group destroyed and made again
in one launch can read the first group's keys from the launcher's store.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
for p in (str(TESTS.parent), str(TESTS)):
    if p not in sys.path:
        sys.path.insert(0, p)

from deepim_tpu_torch.config import Config, TrainConfig, TrainIterConfig, update_config_dict  # noqa: E402
from deepim_tpu_torch.engine import (  # noqa: E402
    EngineConfig,
    MeshBuffers,
    Observation,
    TrainBatch,
    TrainState,
    make_optimizer,
    make_train_step,
    warmup_multifactor_schedule,
)
from deepim_tpu_torch.models import FlowNetDeepIM  # noqa: E402
from deepim_tpu_torch.parallel import (  # noqa: E402
    gather_batch,
    initialize_distributed,
    make_mesh,
    refine_dp,
    replicate_pytree,
    shard_pytree_batch,
    shutdown_distributed,
    train_step_dp,
)
from deepim_tpu_torch.render.rasterizer import RasterConfig  # noqa: E402

torch.set_num_threads(2)

# tests/test_parallel.py's ECFG and training losses.
ECFG = EngineConfig(
    height=64, width=64,
    raster=RasterConfig(height=64, width=64, tile_h=8, tile_w=64, max_faces_per_tile=64, chunk=16, znear=0.05,
                        zfar=10.0),
    update_mask="box_gt", num_iters=2,
)
TICFG = TrainIterConfig(SE3_PM_LOSS=True, LW_PM=0.1, NUM_3D_SAMPLE=16, LW_FLOW=0.25, LW_MASK=0.03)
BATCH_FIELDS = ("image_observed", "mask_observed", "mask_gt_observed", "depth_gt_observed", "pose_rendered",
                "pose_observed", "class_index", "points_model", "points_weights", "k")


def _model(weights: dict) -> FlowNetDeepIM:
    model = FlowNetDeepIM(input_hw=(64, 64), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def _state(weights: dict) -> TrainState:
    model = _model(weights)
    return TrainState(model, make_optimizer(model.parameters(), TrainConfig(),
                                            warmup_multifactor_schedule(1e-4, (1000,))))


def _params(model, tag: str) -> dict:
    return {f"{tag}p/{k}": v.detach().numpy() for k, v in model.state_dict().items()}


def engine(work: Path, out: dict) -> None:
    inp = dict(np.load(work / "engine_in.npz"))
    weights = {k[2:]: v for k, v in inp.items() if k.startswith("w/")}
    bank = tuple(inp[f"bank_{k}"] for k in ("vertices", "colors", "faces", "face_valid"))
    batch = TrainBatch(**{k: torch.from_numpy(inp[k]) for k in BATCH_FIELDS})
    mesh = make_mesh(device="cpu")

    # train_step_dp: the rank's rows of the global batch.
    state = _state(weights)
    step = train_step_dp(make_train_step(ECFG, TICFG, "viz", device="cpu"), mesh, state)
    state, metrics, pose = step(state, shard_pytree_batch(batch, mesh), bank)
    out.update(_params(state.model, "dp/"), dp_step=state.step, dp_count=state.optimizer.count,
               dp_pose=pose.numpy(), dp_pose_all=gather_batch(pose, mesh).numpy(),
               **{f"dp/m/{k}": v.numpy() for k, v in metrics.items()})
    if mesh.rank == 0:
        one = _state(weights)
        one, metrics, pose = make_train_step(ECFG, TICFG, "viz", device="cpu")(one, batch, bank)
        out.update(_params(one.model, "one/"), one_pose=pose.numpy(),
                   **{f"one/m/{k}": v.numpy() for k, v in metrics.items()})

    # refine_dp: the whole batch back on every rank.
    model = _model(weights).eval()
    obs = Observation(batch.image_observed, batch.mask_observed, None, None, batch.k)
    final, poses = refine_dp(model, obs, MeshBuffers.gather(bank, batch.class_index, device="cpu"),
                             batch.pose_rendered, ECFG, mesh)
    out.update(refine_final=final.numpy(), refine_poses=poses.numpy())

    # track_video_sharded over the ranks, the oracle in place of the network.
    from deepim_tpu_torch.engine import track_video_sharded
    from test_torch_tracker import TorchCentroidOracle, _port_ecfg
    from test_tracker import ECFG as TRACK_ECFG

    tbank = {k: inp[f"track_bank_{k}"] for k in ("vertices", "colors", "faces", "face_valid")}
    final, poses = track_video_sharded(
        TorchCentroidOracle(), inp["track_frames"], MeshBuffers.gather(tbank, [0, 1], device="cpu"),
        torch.from_numpy(inp["track_k"]), torch.from_numpy(inp["track_pose0"]), _port_ecfg(TRACK_ECFG),
        mesh=mesh, iters_per_frame=2)
    out.update(track_final=final.numpy(), track_poses=poses.numpy())

    # replicate_pytree: rank 0's values everywhere; gather_batch: rank order.
    rep = replicate_pytree({"a": np.full((2, 3), mesh.rank, np.float32), "b": [torch.tensor([mesh.rank + 5])]},
                           mesh)
    out.update(replicated_a=rep["a"].numpy(), replicated_b=rep["b"][0].numpy(),
               gathered=gather_batch(torch.full((1, 2), float(mesh.rank)), mesh).numpy(),
               gathered_dim1=gather_batch(torch.full((3, 1), float(mesh.rank)), mesh, dim=1).numpy())


def _recorders(rec: dict):
    """A Speedometer that hears every batch and a TBLogger that keeps each
    step's learning rate, honouring train_net's `enabled` (rank 0 only)."""

    class Speedo:
        def __init__(self, batch_size, frequent=20):
            self.frequent = 1

        def __call__(self, epoch, nbatch, metrics=None):
            rec.setdefault("heard", []).append(nbatch)

    class TB:
        def __init__(self, log_dir, enabled=True):
            self.enabled = enabled

        def scalars(self, metrics, step, prefix="train"):
            rec.setdefault("lr", []).append((int(step), float(metrics["lr"])))

        def weight_norms(self, *args):
            pass

        def flush(self):
            pass

        def close(self):
            pass

    return Speedo, TB


def driver(work: Path, out: dict) -> None:
    from deepim_tpu_torch.tools import train_net as t_train_net
    from deepim_tpu_torch.tools import train_test

    inp = dict(np.load(work / "driver_in.npz"))
    cfg = update_config_dict(Config(), json.loads((work / "driver_cfg.json").read_text()))
    saved = t_train_net.build_model, t_train_net.Speedometer, t_train_net.TBLogger
    rec = {}
    t_train_net.build_model = lambda cfg, device: saved[0](cfg, dtype=torch.float32, device=device)
    t_train_net.Speedometer, t_train_net.TBLogger = _recorders(rec)
    try:
        state = t_train_net.train_net(cfg, device="cpu",
                                      init_state_dict={k[2:]: torch.from_numpy(v) for k, v in inp.items()})
    finally:
        t_train_net.build_model, t_train_net.Speedometer, t_train_net.TBLogger = saved
    epoch = state.epochs[0]
    out.update(_params(state.model, ""), step=state.step, count=state.optimizer.count, samples=epoch["samples"],
               lr=np.asarray(rec.get("lr", []), np.float64).reshape(-1, 2), heard=np.asarray(rec.get("heard", [])),
               **{f"m/{k}": v for k, v in epoch["metrics"].items()})

    # The front door in the group this rank joined (main neither joins nor
    # leaves it then).
    result = train_test.main(["--cfg", str(work / "front_door.yaml"), "--device", "cpu"])
    out.update(front_door_none=result is None,
               front_door_pairs=-1 if result is None else result["run"]["pairs"])


def main() -> None:
    """Join the group, run the mode, leave the group, write this rank's
    outputs and exit at once: a torch.distributed.run launch ends only when
    every rank's process has, so nothing is left to run at exit."""
    mode, work = sys.argv[1], Path(sys.argv[2])
    out = {}
    if not initialize_distributed(device="cpu"):
        raise RuntimeError("no torch.distributed launcher environment")
    rank = torch.distributed.get_rank()
    (engine if mode == "engine" else driver)(work, out)
    shutdown_distributed()
    np.savez(work / f"{mode}_rank{rank}.npz", **out)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
