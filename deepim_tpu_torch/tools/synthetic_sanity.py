"""The synthetic end-to-end learning check (counterpart of
experiments/synthetic_sanity.py): train the matching network on a generated
cube and sphere devkit and compare the refined poses' ADD on held-out pairs
with the perturbed initial poses'.  It drives the whole learning loop
(rasterizer, zoom, network, the untangled update, the label refresh on the
device, the optimizer) without LINEMOD files.

    python -m deepim_tpu_torch.tools.synthetic_sanity [--epochs 24] [--n-train 512] [--n-val 64]
        [--size 128] [--out <devkit dir>] [--overfit] [--device cuda|cpu]

The devkit (generated once, reused while its image_set/ exists) and the run
(<out>/run/synth_ckpt/<epoch>) go under --out, by default
<tempdir>/synth_lm6d_<size>.  --overfit evaluates on the training pairs (a
capacity check: refinement must become near-perfect on seen data).  It
prints each class's ADD<0.1d and mean ADD of the initial poses beside
every iteration's; main returns them with test_deepim's results.  Without
CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from deepim_tpu_torch.config import Config, update_config_dict
from deepim_tpu_torch.data.pairdb import load_gt_pairdb
from deepim_tpu_torch.eval.evaluator import _add_errors
from deepim_tpu_torch.render.mesh import make_icosphere, make_test_cube
from deepim_tpu_torch.render.rasterizer import RasterConfig
from deepim_tpu_torch.tools.benchmark_multiclass import fresh_results
from deepim_tpu_torch.tools.synth_data import generate_dataset
from deepim_tpu_torch.tools.train_net import train_net

CLASSES = ("cube", "sphere")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="synthetic end-to-end learning check (PyTorch port)")
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default=None, help="devkit and run directory (default: under the temp directory)")
    ap.add_argument("--overfit", action="store_true",
                    help="evaluate on the training pairs (capacity check: refinement must become near-perfect "
                    "on seen data)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def sanity_k(size: int) -> np.ndarray:
    """The check's pinhole intrinsics: focal 1.2 h, centred."""
    return np.array([[1.2 * size, 0.0, size / 2], [0.0, 1.2 * size, size / 2], [0.0, 0.0, 1.0]], np.float32)


def sanity_config(args: argparse.Namespace, devkit: str) -> Config:
    """The JAX harness's config for these flags, field for field: Adam
    and LW_PM 1.0 for training from random weights (the reference's SGD
    and LW_PM 0.1 assume a pretrained FlowNet), box_gt masks."""
    h = w = args.size
    return update_config_dict(Config(), {
        "SCALES": [h, w],
        "output_path": os.path.join(devkit, "output"),
        "dataset": {
            "dataset": "LM6D_REFINE", "dataset_path": devkit, "root_path": devkit,
            "image_set": "train_",
            "test_image_set": "train_" if args.overfit else "val_",
            "model_dir": os.path.join(devkit, "models"),
            "class_name": list(CLASSES),
            "INTRINSIC_MATRIX": sanity_k(h).flatten().tolist(),
            "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {
            "INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True,
            "TRAIN_ITER": True, "TRAIN_ITER_SIZE": 2,
            "PIXEL_MEANS": [123.68, 116.779, 103.939],
        },
        "train_iter": {
            "SE3_PM_LOSS": True, "LW_PM": 1.0, "NUM_3D_SAMPLE": 512,
            "LW_FLOW": 0.25, "LW_MASK": 0.01,
        },
        "TRAIN": {
            "optimizer": "adam",
            "BATCH_PAIRS": 16, "end_epoch": args.epochs,
            "warmup": True, "warmup_lr": 1e-5, "warmup_step": 50,
            "lr": 3e-4, "lr_step": f"{args.epochs * 3 // 4}",
            "momentum": 0.975, "grad_clip": 1.0,
            "INIT_MASK": "box_gt", "UPDATE_MASK": "box_gt", "MASK_DILATE": True,
            "model_prefix": "synth",
        },
        "TEST": {"test_iter": 4, "test_epoch": args.epochs},
    })


def main(argv: list[str] | None = None) -> dict:
    """Generate the devkit (if absent), train, test and print the ADD
    table.  Returns {'classes': {cls: {'init_acc', 'init_mean', 'acc',
    'mean'}} (ADD<0.1d in percent and mean ADD in metres, 'acc' and 'mean'
    one a refinement iteration), 'results' (test_deepim's), 'epochs'
    (train_net's per-epoch figures)}."""
    args = parse_args(argv)
    h = w = args.size
    k = sanity_k(h)
    devkit = args.out or os.path.join(tempfile.gettempdir(), f"synth_lm6d_{h}")
    if not os.path.exists(os.path.join(devkit, "image_set")):
        print("generating dataset at", devkit, flush=True)
        meshes = {"cube": make_test_cube(0.1), "sphere": make_icosphere(0.06, 2)}
        generate_dataset(devkit, meshes, k, n_train=args.n_train, n_val=args.n_val, height=h, width=w,
                         z_range=(0.5, 0.8), raster_cfg=RasterConfig(height=h, width=w, znear=0.05, zfar=10.0),
                         device=args.device)

    cfg = sanity_config(args, devkit)
    run_dir = os.path.join(devkit, "run")
    os.makedirs(run_dir, exist_ok=True)
    state = train_net(cfg, output_dir=run_dir, device=args.device)
    results = fresh_results(cfg, run_dir, state.model, 16, args.device)

    # The initial (perturbed) poses' error beside the refined ones': the
    # reference's tables never show iteration 0, so it comes from the pairdb.
    print("\n==== refinement quality (ADD) ====")
    table = {}
    for cls in CLASSES:
        db, pairdb = load_gt_pairdb(cfg, "LM6D_REFINE", cfg.dataset.test_image_set + cls, cls,
                                    cfg.dataset.root_path, cfg.dataset.dataset_path)
        pose0 = np.stack([r["pose_rendered"] for r in pairdb])
        pose_gt = np.stack([r["pose_observed"] for r in pairdb])
        init_errs = _add_errors(pose0, pose_gt, db.points(cls))
        iters = range(cfg.TEST.test_iter)
        row = {
            "init_acc": float(np.mean(init_errs < 0.10 * db.diameter(cls)) * 100),
            "init_mean": float(np.mean(init_errs)),
            "acc": [results["add"][cls][it]["0.10"] for it in iters],
            "mean": [float(np.mean(results["add"][cls][it]["errors"])) for it in iters],
        }
        table[cls] = row
        print(f"{cls}: ADD<0.1d init {row['init_acc']:.1f}% -> per-iter {row['acc']}")
        print(f"{cls}: mean ADD error init {row['init_mean']:.4f} -> per iter {['%.4f' % m for m in row['mean']]}")
    return {"classes": table, "results": results, "epochs": state.epochs}


if __name__ == "__main__":
    main()
