"""Closed-loop video tracking with a learned checkpoint (counterpart of
experiments/track_learned.py): a smoothly tumbling and orbiting sequence
for each of the first --track-classes benchmark classes, rendered by the
port's rasterizer, tracked by engine/tracker.py:make_tracker from a frame-0
pose with PoseCNN-like noise (15 deg, (0.01, 0.01, 0.05) m), with the
network that benchmark_multiclass (or track_finetune) trained.  It reports
each class's per-frame ADD, ADI, rotation and translation errors against
the ground-truth trajectory.

    python -m deepim_tpu_torch.tools.track_learned [--epochs 30] [--frames 60] [--size 128]
        [--classes 13] [--track-classes 4] [--subdiv 3] [--iters-per-frame 2] [--init-iters 0]
        [--devkit <dir>] [--prefix bench13] [--run-dir <dir>] [--device cuda|cpu]

The checkpoint is <run-dir>/<prefix>_ckpt/<epochs>, <run-dir> by default
<devkit>/run and <devkit> benchmark_multiclass's default for --classes,
--size and --subdiv.  It prints one "TRACK_JSON {...}" line, a markdown
table, the track's wall time and the CSR pairs the renders dropped; main
returns them.  Without CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from deepim_tpu_torch.device import resolve_device, set_explicit_precision, synchronize
from deepim_tpu_torch.engine.checkpoint import load_checkpoint
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, tune_raster_for_bank
from deepim_tpu_torch.engine.tracker import make_tracker
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.eval.evaluator import _add_errors, _adi_errors
from deepim_tpu_torch.models import FlowNetDeepIM
from deepim_tpu_torch.render.mesh import MeshBank, make_benchmark_classes
from deepim_tpu_torch.render.rasterizer import RasterConfig, rasterize
from deepim_tpu_torch.tools.benchmark_multiclass import PREFIX, benchmark_k, default_devkit

PIXEL_MEANS = (123.68, 116.779, 103.939)
STEP_DEG = 2.5  # the tumble a frame


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="closed-loop tracking with a learned checkpoint (PyTorch port)")
    ap.add_argument("--epochs", type=int, default=30, help="checkpoint epoch to load")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--classes", type=int, default=13, help="must match the benchmark run")
    ap.add_argument("--track-classes", type=int, default=4, help="videos tracked (batch)")
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--iters-per-frame", type=int, default=2)
    ap.add_argument("--init-iters", type=int, default=0,
                    help="extra frame-0 lock-on refinement iterations before the first frame's own")
    ap.add_argument("--devkit", default=None)
    ap.add_argument("--prefix", default=PREFIX,
                    help="checkpoint prefix in the run directory (e.g. 'trackft' for the tracking fine-tune)")
    ap.add_argument("--run-dir", default=None, help="checkpoint directory (default <devkit>/run)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_sequence(classes: list[str], frames: int, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """The ground-truth trajectory and the frame-0 initial poses, drawn as
    the JAX harness draws them from one RandomState(seed): each object
    tumbles STEP_DEG a frame about a random axis from a random rotation
    while its translation orbits (x, y, z) = (0.03 sin, 0.02 cos, 0.6 +
    0.05 sin); frame 0's pose then takes Euler noise N(0, 15 deg) and
    translation noise N(0, (0.01, 0.01, 0.05)) m.  Returns poses_gt
    (frames, B, 3, 4) and pose0 (B, 3, 4), float32."""
    b = len(classes)
    rng = np.random.RandomState(seed)
    axis = rng.randn(b, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rot0 = R.random(b, random_state=rng).as_matrix()
    poses_gt = np.zeros((frames, b, 3, 4), np.float32)
    for t in range(frames):
        ang = np.deg2rad(STEP_DEG) * t
        for i in range(b):
            poses_gt[t, i, :, :3] = R.from_rotvec(axis[i] * ang).as_matrix() @ rot0[i]
        phase = 2 * np.pi * t / frames
        poses_gt[t, :, 0, 3] = 0.03 * np.sin(phase + np.arange(b))
        poses_gt[t, :, 1, 3] = 0.02 * np.cos(phase + np.arange(b))
        poses_gt[t, :, 2, 3] = 0.6 + 0.05 * np.sin(phase)
    pose0 = poses_gt[0].copy()
    for i in range(b):
        noise = R.from_euler("xyz", rng.normal(0, 15, 3), degrees=True).as_matrix()
        pose0[i, :, :3] = noise @ pose0[i, :, :3]
    for axis_i, std in enumerate((0.01, 0.01, 0.05)):
        pose0[:, axis_i, 3] += rng.normal(0, std, b)
    return poses_gt, pose0


def render_frames(meshes: MeshBuffers, poses_gt: np.ndarray, k: np.ndarray, rcfg: RasterConfig,
                  device="cuda") -> np.ndarray:
    """The observed video: each frame's B objects rendered in one batch at
    their ground-truth poses -> (T, B, 3, H, W) float32 RGB in [0, 255]."""
    dev = resolve_device(device)
    kt = torch.from_numpy(k).to(dev)
    out = np.zeros((len(poses_gt), poses_gt.shape[1], 3, rcfg.height, rcfg.width), np.float32)
    for t, pose in enumerate(poses_gt):
        rgb, _ = rasterize(meshes.vertices, meshes.colors, meshes.faces, meshes.face_valid,
                           torch.from_numpy(pose).to(dev), kt, rcfg, corners=meshes.corners,
                           corner_colors=meshes.corner_colors, device=dev)
        out[t] = rgb.permute(0, 3, 1, 2).cpu().numpy()
    return out


def load_tracking_model(run_dir: str, prefix: str, epoch: int, h: int, w: int, device="cuda") -> FlowNetDeepIM:
    """The bf16 FlowNetDeepIM with flow and mask heads, its weights those
    of <run_dir>/<prefix>_ckpt/<epoch> (built on the meta device: every
    parameter comes from the file)."""
    model = FlowNetDeepIM(input_hw=(h, w), pred_flow=True, pred_mask=True, dtype=torch.bfloat16,
                          device="meta").eval()
    load_checkpoint(os.path.join(run_dir, prefix), epoch, TrainState(model, None))
    return model.to(resolve_device(device))


def tracking_engine(h: int, w: int, iters_per_frame: int, bank_arrays, k: np.ndarray) -> EngineConfig:
    """The JAX harness's engine: box_rendered update masks, iters_per_frame
    iterations, the benchmark's pixel means, the pair budget sized for the
    bank."""
    ecfg = EngineConfig(height=h, width=w, raster=RasterConfig(height=h, width=w, znear=0.05, zfar=10.0),
                        update_mask="box_rendered", num_iters=iters_per_frame, pixel_means=PIXEL_MEANS)
    return tune_raster_for_bank(ecfg, bank_arrays, k)


def score_track(poses_est: np.ndarray, poses_gt: np.ndarray, pose0: np.ndarray, meshes: list,
                classes: list[str], **meta) -> tuple[list[dict], dict]:
    """Each class's errors over the track (poses (T, B, 3, 4)): ADD, ADI,
    geodesic rotation (degrees) and translation, over the mesh's diameter
    where it is a distance, and frame 0's initial ADD.  Returns (rows,
    summary): the summary holds the frames, `meta` (the JAX harness's
    iters_per_frame, init_iters, prefix and epochs), the means of the rows'
    ADD<0.1d share and mean ADD/d, and the rows as 'per_class'."""
    t_frames = len(poses_gt)
    rows = []
    for i, cls in enumerate(classes):
        pts = meshes[i].vertices
        d = meshes[i].diameter()
        est, gt = poses_est[:, i].astype(np.float64), poses_gt[:, i].astype(np.float64)
        add = _add_errors(est, gt, pts)
        add_init = _add_errors(np.tile(pose0[i][None], (t_frames, 1, 1)).astype(np.float64), gt, pts)
        re = poses_est[:, i, :, :3] @ np.transpose(poses_gt[:, i, :, :3], (0, 2, 1))
        rot_deg = np.degrees(np.arccos(np.clip((np.trace(re, axis1=1, axis2=2) - 1) / 2, -1, 1)))
        trans_m = np.linalg.norm(poses_est[:, i, :, 3] - poses_gt[:, i, :, 3], axis=1)
        adi = _adi_errors(est, gt, pts)
        rows.append({
            "class": cls,
            "add_lt_0.1d_pct": float(np.mean(add < 0.1 * d) * 100),
            "mean_add_over_d": float(np.mean(add / d)),
            "max_add_over_d": float(np.max(add / d)),
            "final_add_over_d": float(add[-1] / d),
            "frame0_init_add_over_d": float(add_init[0] / d),
            "adi_lt_0.1d_pct": float(np.mean(adi < 0.1 * d) * 100),
            "mean_adi_over_d": float(np.mean(adi / d)),
            "mean_rot_deg": float(np.mean(rot_deg)),
            "final_rot_deg": float(rot_deg[-1]),
            "mean_trans_over_d": float(np.mean(trans_m / d)),
        })
    summary = {
        "frames": t_frames,
        **meta,
        "mean_add_lt_0.1d_pct": float(np.mean([r["add_lt_0.1d_pct"] for r in rows])),
        "mean_add_over_d": float(np.mean([r["mean_add_over_d"] for r in rows])),
        "per_class": rows,
    }
    return rows, summary


def main(argv: list[str] | None = None) -> dict:
    """Render the sequence, track it, score and print.  Returns {'summary'
    (the TRACK_JSON object), 'poses_gt', 'pose0', 'frames', 'poses_est'
    (numpy), 'run': {'render_s', 'track_s' (staging the video on the
    device to the poses on the host), 'frames_per_s' (tracked frames a
    second of track_s), 'raster_dropped'}}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_explicit_precision()
    h = w = args.size
    k = benchmark_k(h, w)
    devkit = args.devkit or default_devkit(args.classes, h, args.subdiv)
    run_dir = args.run_dir or os.path.join(devkit, "run")
    meshes_by_name = make_benchmark_classes(args.classes, subdiv=args.subdiv)
    classes = sorted(meshes_by_name)[: args.track_classes]
    mesh_list = [meshes_by_name[c] for c in classes]
    bank_arrays = MeshBank.from_meshes(mesh_list).arrays()
    meshes = MeshBuffers.gather(bank_arrays, np.arange(len(classes)), device=dev)

    model = load_tracking_model(run_dir, args.prefix, args.epochs, h, w, device=dev)
    ecfg = tracking_engine(h, w, args.iters_per_frame, bank_arrays, k)
    poses_gt, pose0 = make_sequence(classes, args.frames)
    run = {}
    t0 = time.perf_counter()
    frames = render_frames(meshes, poses_gt, k, ecfg.raster, device=dev)
    run["render_s"] = time.perf_counter() - t0

    track = make_tracker(model, ecfg, args.iters_per_frame, init_iters=args.init_iters, with_stats=True, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    _, poses, stats = track(torch.from_numpy(frames), meshes, torch.from_numpy(k), torch.from_numpy(pose0))
    poses_est = poses.cpu().numpy()
    run["track_s"] = time.perf_counter() - t0
    run["frames_per_s"] = args.frames / run["track_s"]
    run["raster_dropped"] = int(stats["raster_dropped"])

    _, summary = score_track(poses_est, poses_gt, pose0, mesh_list, classes, iters_per_frame=args.iters_per_frame,
                             init_iters=args.init_iters, prefix=args.prefix, epochs=args.epochs)
    print("TRACK_JSON " + json.dumps(summary))
    print("\n| class | ADD<0.1d %frames | mean ADD/d | max ADD/d | final ADD/d | init ADD/d |")
    print("|---|---|---|---|---|---|")
    for r in summary["per_class"]:
        print("| %s | %.1f | %.3f | %.3f | %.3f | %.3f |" % (
            r["class"], r["add_lt_0.1d_pct"], r["mean_add_over_d"], r["max_add_over_d"],
            r["final_add_over_d"], r["frame0_init_add_over_d"]))
    print("\ntrack: %d frames x %d videos in %.3f s (%.2f frames/s, render %.3f s), raster_dropped %d" % (
        args.frames, len(classes), run["track_s"], run["frames_per_s"], run["render_s"], run["raster_dropped"]),
        flush=True)
    return {"summary": summary, "poses_gt": poses_gt, "pose0": pose0, "frames": frames, "poses_est": poses_est,
            "run": run}


if __name__ == "__main__":
    main()
