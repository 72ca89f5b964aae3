"""The synthetic accuracy benchmark (counterpart of
experiments/benchmark_multiclass.py): 13 asymmetric, vertex-coloured
procedural classes (render.mesh.make_benchmark_classes) with the
toolkit's initial-pose noise (15 deg, (0.01, 0.01, 0.05) m), trained from
scratch and evaluated with the full protocol (per-iteration ADD(-S) at
0.02/0.05/0.10 x diameter and its AUC, 5cm5deg, Proj2D at 2/5/10/20 px)
beside the initial poses' own accuracy on the held-out pairs.

    python -m deepim_tpu_torch.tools.benchmark_multiclass [--epochs 30] [--size 128] [--classes 13]
        [--n-train 256] [--n-val 32] [--batch 32] [--train-iter-size 2] [--lw-flow 0.25]
        [--out <devkit dir>] [--device cuda|cpu]

The devkit (generated once, reused while its image_set/ exists), the run's
checkpoints (<out>/run/bench13_ckpt/<epoch>) and results go under --out,
by default <tempdir>/bench13_<classes>c_<size>_<subdiv>.  It prints one
"BENCH13_JSON {...}" line and a markdown table; main returns the table
with the run's figures.  Without CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from deepim_tpu_torch.config import Config, update_config_dict
from deepim_tpu_torch.data.pairdb import load_gt_pairdb
from deepim_tpu_torch.engine.checkpoint import load_checkpoint, merge_matching_params, read_checkpoint
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.eval.evaluator import PoseEvaluator, _add_errors
from deepim_tpu_torch.render.mesh import make_benchmark_classes
from deepim_tpu_torch.render.rasterizer import RasterConfig
from deepim_tpu_torch.tools.synth_data import generate_dataset
from deepim_tpu_torch.tools.test_net import test_deepim
from deepim_tpu_torch.tools.train_net import build_model, train_net

PREFIX = "bench13"


def benchmark_k(h: int, w: int) -> np.ndarray:
    """The benchmark's pinhole intrinsics: focal 1.35 h, centred."""
    return np.array([[1.35 * h, 0.0, w / 2], [0.0, 1.35 * h, h / 2], [0.0, 0.0, 1.0]], np.float32)


def default_devkit(classes: int, h: int, subdiv: int, w: int = 0) -> str:
    return os.path.join(tempfile.gettempdir(), f"bench13_{classes}c_{h}_{subdiv}" + (f"x{w}" if w else ""))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="13-class synthetic accuracy benchmark (PyTorch port)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-train", type=int, default=256, help="train pairs per class")
    ap.add_argument("--n-val", type=int, default=32, help="val pairs per class")
    ap.add_argument("--size", type=int, default=128, help="frame height (and width unless --width)")
    ap.add_argument("--width", type=int, default=0,
                    help="frame width (0 = square --size x --size); 640 with --size 480 is the reference's full "
                    "resolution (deepim_flownet_LM_SIXD_v1_..._RFMx4_8epoch.yaml)")
    ap.add_argument("--classes", type=int, default=13)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lw-flow", type=float, default=0.25,
                    help="flow-loss weight (0 disables flow supervision)")
    ap.add_argument("--train-iter-size", type=int, default=2,
                    help="iterated-training depth; 4 = the reference's RFMx4 protocol "
                    "(deepim_flownet_LM_SIXD_v1_..._RFMx4_8epoch.yaml:58)")
    ap.add_argument("--out", default=None, help="devkit and run directory (default: under the temp directory)")
    ap.add_argument("--test-only", action="store_true")
    ap.add_argument("--train-only", action="store_true",
                    help="train (or resume) and exit before evaluation, for a run split into chunks of "
                    "epochs, each a process of its own (with --resume-epoch)")
    ap.add_argument("--resume-epoch", type=int, default=0, help="resume training from this epoch's checkpoint")
    ap.add_argument("--seed-convs", default=None,
                    help="checkpoint PREFIX path (e.g. <out>/run/bench13) whose resolution-independent "
                    "parameters seed this run (fc6 depends on the frame size and keeps the fresh init): "
                    "cross-resolution transfer for the 480x640 protocol")
    ap.add_argument("--seed-epoch", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def benchmark_config(args: argparse.Namespace, devkit: str, classes: list[str], k: np.ndarray) -> Config:
    """The JAX runner's config for these flags, field for field."""
    h, w = args.size, args.width or args.size
    return update_config_dict(Config(), {
        "SCALES": [h, w],
        "output_path": os.path.join(devkit, "output"),
        "dataset": {
            "dataset": "LM6D_REFINE", "dataset_path": devkit, "root_path": devkit,
            "image_set": "train_", "test_image_set": "val_",
            "model_dir": os.path.join(devkit, "models"),
            "class_name": classes,
            "INTRINSIC_MATRIX": k.flatten().tolist(),
            "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {
            "INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True,
            "TRAIN_ITER": True, "TRAIN_ITER_SIZE": args.train_iter_size,
            "PIXEL_MEANS": [123.68, 116.779, 103.939],
        },
        "train_iter": {
            "SE3_PM_LOSS": True, "LW_PM": 1.0, "NUM_3D_SAMPLE": 512,
            "LW_FLOW": args.lw_flow,
            # The mask BCE is summed over pixels, so its gradient grows with
            # the frame's area: keep the 128x128 weight's effect at any size.
            "LW_MASK": 0.01 * (128.0 * 128.0) / (h * w),
        },
        "TRAIN": {
            "optimizer": "adam",
            "BATCH_PAIRS": args.batch, "end_epoch": args.epochs,
            "warmup": True, "warmup_lr": 1e-5, "warmup_step": 200,
            "lr": args.lr, "lr_step": f"{args.epochs * 2 // 3}, {args.epochs * 5 // 6}",
            "grad_clip": 1.0,
            "INIT_MASK": "box_gt", "UPDATE_MASK": "box_gt", "MASK_DILATE": True,
            "model_prefix": PREFIX, "CHECKPOINT_INTERVAL": 5,
            "RESUME": args.resume_epoch > 0, "begin_epoch": args.resume_epoch,
        },
        "TEST": {"test_iter": 4, "test_epoch": args.epochs, "FAST_TEST": False, "UPDATE_MASK": "box_rendered"},
    })


def init_pose_rows(cfg: Config, classes: list[str], k: np.ndarray) -> dict:
    """Each class's accuracy of the initial poses on its val pairs:
    {'ADD<0.1d', '5cm5deg', 'Proj2D@5px'}: one value a class, in percent."""
    rows = {"ADD<0.1d": [], "5cm5deg": [], "Proj2D@5px": []}
    for cls in classes:
        db, pairdb = load_gt_pairdb(cfg, "LM6D_REFINE", "val_" + cls, cls, cfg.dataset.root_path,
                                    cfg.dataset.dataset_path)
        pts = db.points(cls)
        pose0 = np.stack([r["pose_rendered"] for r in pairdb]).astype(np.float64)
        pose_gt = np.stack([r["pose_observed"] for r in pairdb]).astype(np.float64)
        d = db.diameter(cls)
        rows["ADD<0.1d"].append(float(np.mean(_add_errors(pose0, pose_gt, pts) < 0.1 * d) * 100))
        ev = PoseEvaluator([cls], {cls: pts}, {cls: d}, k, 1)
        rows["5cm5deg"].append(ev.evaluate_pose([[list(pose0)]], [[list(pose_gt)]])[cls][0]["acc_5cm_5deg"])
        rows["Proj2D@5px"].append(ev.evaluate_pose_arp_2d([[list(pose0)]], [[list(pose_gt)]])[cls][0]["5"])
    return rows


def fresh_results(cfg: Config, run_dir: str, model, batch: int, device) -> dict:
    """test_deepim on `model` with the pose cache of an earlier run removed."""
    cache = os.path.join(run_dir, "results_pose.pkl")
    if os.path.exists(cache):
        os.remove(cache)
    return test_deepim(cfg, output_dir=run_dir, batch_size=batch, device=device, model=model)


def main(argv: list[str] | None = None) -> dict | None:
    """Generate the devkit (if absent), train (or load with --test-only),
    test and print the tables.  Returns {'table', 'epochs' (train_net's
    per-epoch figures, empty with --test-only), 'run' (test_deepim's),
    'generation': {'pairs', 'seconds'} (pairs 0 when the devkit existed)},
    or None with --train-only."""
    t_start = time.perf_counter()
    args = parse_args(argv)
    h, w = args.size, args.width or args.size
    k = benchmark_k(h, w)
    devkit = args.out or default_devkit(args.classes, h, args.subdiv, args.width)
    meshes = make_benchmark_classes(args.classes, subdiv=args.subdiv)
    classes = sorted(meshes.keys())
    generation = {"pairs": 0, "seconds": 0.0}
    if not os.path.exists(os.path.join(devkit, "image_set")):
        print("generating dataset at", devkit, flush=True)
        t0 = time.perf_counter()
        generate_dataset(devkit, meshes, k, n_train=args.n_train, n_val=args.n_val, height=h, width=w,
                         z_range=(0.45, 0.75), raster_cfg=RasterConfig(height=h, width=w, znear=0.05, zfar=10.0),
                         device=args.device)
        generation = {"pairs": len(classes) * (args.n_train + args.n_val), "seconds": time.perf_counter() - t0}

    cfg = benchmark_config(args, devkit, classes, k)
    run_dir = os.path.join(devkit, "run")
    os.makedirs(run_dir, exist_ok=True)
    epochs = []
    if args.test_only:
        model = build_model(cfg, device=args.device)
        load_checkpoint(os.path.join(run_dir, PREFIX), args.epochs, TrainState(model, None))
    else:
        init = None
        if args.seed_convs and args.resume_epoch == 0:
            fresh = build_model(cfg, device="cpu").state_dict()
            init, skipped = merge_matching_params(fresh, read_checkpoint(args.seed_convs, args.seed_epoch)["model"])
            print("seeded convs from %s epoch %d (fresh: %s)" % (args.seed_convs, args.seed_epoch,
                                                                  ", ".join(skipped) or "none"), flush=True)
        state = train_net(cfg, output_dir=run_dir, device=args.device, init_state_dict=init)
        model, epochs = state.model, state.epochs
        print_epochs(epochs)
    if args.train_only:
        print("train-only: stopped after epoch", args.epochs, flush=True)
        return None
    results = fresh_results(cfg, run_dir, model, args.batch, args.device)

    init_rows = init_pose_rows(cfg, classes, k)

    def mean_over_classes(block, key, it):
        return float(np.mean([results[block][c][it][key] for c in classes]))

    table = {
        "init": {key: float(np.mean(values)) for key, values in init_rows.items()},
        "iters": [
            {
                "ADD<0.1d": mean_over_classes("add", "0.10", it),
                "ADD auc": mean_over_classes("add", "auc", it),
                "5cm5deg": mean_over_classes("pose", "acc_5cm_5deg", it),
                "Proj2D@5px": mean_over_classes("arp_2d", "5", it),
            }
            for it in range(cfg.TEST.test_iter)
        ],
    }
    # The flow head's end-point error per iteration beside the pose metrics.
    if "flow_epe" in results:
        for it, row in enumerate(results["flow_epe"].get("per_iter", [])):
            if it < len(table["iters"]):
                table["iters"][it]["EPE_viz"] = round(float(row["epe_viz"]), 3)
                table["iters"][it]["EPE_all"] = round(float(row["epe_all"]), 3)
    print("\nBENCH13_JSON " + json.dumps(table))
    print("\n==== README table (mean over %d classes, %d held-out pairs/class) ====" % (len(classes), args.n_val))
    print("| stage | ADD(-S)<0.1d | 5cm5deg | Proj2D@5px |")
    print("|---|---|---|---|")
    print("| init (PoseCNN-noise) | %.1f | %.1f | %.1f |" % (
        table["init"]["ADD<0.1d"], table["init"]["5cm5deg"], table["init"]["Proj2D@5px"]))
    for it, row in enumerate(table["iters"]):
        print("| iter %d | %.1f | %.1f | %.1f |" % (it + 1, row["ADD<0.1d"], row["5cm5deg"], row["Proj2D@5px"]))
    print_run(generation, epochs, results.get("run", {}), time.perf_counter() - t_start)
    return {"table": table, "epochs": epochs, "run": results.get("run", {}), "generation": generation}


def print_epochs(epochs: list[dict]) -> None:
    """One line an epoch: its mean loss over steps and inner iterations
    (each term and the total), its samples/s, seconds (and of them the
    time blocked on the loader) and the decode cache's hits and misses."""
    for e in epochs:
        means = {k: float(v.mean()) for k, v in e["metrics"].items() if k.endswith("loss") or k == "total"}
        print("epoch %d: %s; %.2f samples/s, %.1f s (loader wait %.1f s), decode cache %d hits, %d misses" % (
            e["epoch"], ", ".join(f"{k} {v:.5g}" for k, v in sorted(means.items())), e["samples"] / e["loop_s"],
            e["loop_s"], e["wait_s"], e["cache_hits"], e["cache_misses"]), flush=True)


def print_run(generation: dict, epochs: list[dict], run: dict, wall_s: float) -> None:
    """The run's seconds by stage."""
    print("run: generation %.1f s (%d), training %.1f s (%d epochs), test %.1f s (%d pairs), wall %.1f s" % (
        generation["seconds"], generation.get("pairs", generation.get("scenes", 0)),
        sum(e["loop_s"] + e["checkpoint_s"] for e in epochs), len(epochs), run.get("pred_eval_s", 0.0),
        run.get("pairs", 0), wall_s), flush=True)


if __name__ == "__main__":
    main()
