"""The tracking-precision fine-tune (counterpart of
experiments/track_finetune.py): continue the benchmark_multiclass
checkpoint on pairs whose initial poses draw from a noise mix dominated by
small deltas, so the network learns the near-convergence regime a tracker
lives in every frame, while a tail of the standard noise keeps the wide
basin:

    50%  rot N(0, 3 deg) clipped at 9,   trans N(0, (3, 3, 10) mm)
    25%  rot N(0, 8 deg) clipped at 24,  trans N(0, (6, 6, 30) mm)
    25%  the initial-pose noise model (15 deg clipped at 45, (10, 10, 50) mm)

    python -m deepim_tpu_torch.tools.track_finetune [--epochs 60] [--finetune-epochs 20] [--size 128]
        [--classes 13] [--subdiv 3] [--batch 32] [--n-train 256] [--lr 1e-4] [--train-iter-size 2]
        [--devkit <benchmark devkit>] [--device cuda|cpu]

It reads the benchmark's checkpoint <devkit>/run/bench13_ckpt/<epochs>
(<devkit> benchmark_multiclass's default for --classes, --size and
--subdiv), writes its own devkit beside it (<devkit>_trackft, generated
once), copies the checkpoint to <devkit>_trackft/run/trackft_ckpt/<epochs>,
from which train_net resumes, and trains to epochs + finetune-epochs.
Then evaluate with the track_learned command it prints.  Without CUDA it
raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from deepim_tpu_torch.config import Config, update_config_dict
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.engine.checkpoint import checkpoint_path
from deepim_tpu_torch.render.mesh import make_benchmark_classes
from deepim_tpu_torch.render.rasterizer import RasterConfig
from deepim_tpu_torch.tools.benchmark_multiclass import PREFIX, benchmark_k, default_devkit
from deepim_tpu_torch.tools.synth_data import generate_dataset
from deepim_tpu_torch.tools.train_net import train_net

FT_PREFIX = "trackft"
# (weight, rot std deg, rot clip deg, (tx, ty, tz) std m)
NOISE_MIX = [
    (0.50, 3.0, 9.0, (0.003, 0.003, 0.010)),
    (0.25, 8.0, 24.0, (0.006, 0.006, 0.030)),
    (0.25, 15.0, 45.0, (0.010, 0.010, 0.050)),
]


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="tracking-precision fine-tune (PyTorch port)")
    ap.add_argument("--epochs", type=int, default=60, help="bench13 checkpoint epoch to seed from")
    ap.add_argument("--finetune-epochs", type=int, default=20)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--classes", type=int, default=13)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-train", type=int, default=256, help="pairs per class")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--train-iter-size", type=int, default=2, help="2 matches the tracker's iters_per_frame")
    ap.add_argument("--devkit", default=None, help="the benchmark's devkit (its run/ holds the checkpoint)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def finetune_config(args: argparse.Namespace, ft_devkit: str, classes: list[str], k: np.ndarray) -> Config:
    """The JAX fine-tune's config for these flags, field for field: resume
    at --epochs, train to --epochs + --finetune-epochs, one LR step at
    three quarters of the fine-tune."""
    h = w = args.size
    return update_config_dict(Config(), {
        "SCALES": [h, w],
        "output_path": os.path.join(ft_devkit, "output"),
        "dataset": {
            "dataset": "LM6D_REFINE", "dataset_path": ft_devkit, "root_path": ft_devkit,
            "image_set": "train_", "test_image_set": "val_",
            "model_dir": os.path.join(ft_devkit, "models"),
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
            "LW_FLOW": 0.25,
            "LW_MASK": 0.01 * (128.0 / args.size) ** 2,
        },
        "TRAIN": {
            "optimizer": "adam", "BATCH_PAIRS": args.batch,
            "warmup": True, "warmup_lr": 1e-5, "warmup_step": 50,
            "lr": args.lr, "lr_step": f"{args.epochs + args.finetune_epochs * 3 // 4}",
            "grad_clip": 1.0,
            "INIT_MASK": "box_gt", "UPDATE_MASK": "box_gt", "MASK_DILATE": True,
            "model_prefix": FT_PREFIX, "CHECKPOINT_INTERVAL": 5,
            "RESUME": True, "begin_epoch": args.epochs, "end_epoch": args.epochs + args.finetune_epochs,
        },
    })


def seed_checkpoint(bench_devkit: str, run_dir: str, epoch: int) -> str:
    """Copy the benchmark's checkpoint of `epoch` to the fine-tune's prefix
    at the same epoch (kept if already there), where train_net resumes.
    Returns its path."""
    dst = checkpoint_path(os.path.join(run_dir, FT_PREFIX), epoch)
    if not os.path.exists(dst):
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(checkpoint_path(os.path.join(bench_devkit, "run", PREFIX), epoch), dst)
    return dst


def main(argv: list[str] | None = None):
    """Generate the fine-tune devkit (if absent), seed and train.  Returns
    train_net's state (its `epochs` hold each epoch's figures)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h = w = args.size
    k = benchmark_k(h, w)
    bench_devkit = args.devkit or default_devkit(args.classes, h, args.subdiv)
    ft_devkit = bench_devkit + "_trackft"
    meshes = make_benchmark_classes(args.classes, subdiv=args.subdiv)
    classes = sorted(meshes.keys())
    if not os.path.exists(os.path.join(ft_devkit, "image_set")):
        print("generating near-convergence dataset at", ft_devkit, flush=True)
        generate_dataset(ft_devkit, meshes, k, n_train=args.n_train, n_val=16, height=h, width=w,
                         z_range=(0.45, 0.75), raster_cfg=RasterConfig(height=h, width=w, znear=0.05, zfar=10.0),
                         noise_mix=NOISE_MIX, seed=11, device=dev)

    end_epoch = args.epochs + args.finetune_epochs
    cfg = finetune_config(args, ft_devkit, classes, k)
    run_dir = os.path.join(ft_devkit, "run")
    os.makedirs(run_dir, exist_ok=True)
    seed_checkpoint(bench_devkit, run_dir, args.epochs)
    state = train_net(cfg, output_dir=run_dir, device=dev)
    print(f"\nfine-tuned checkpoint: {run_dir}/{FT_PREFIX} epoch {end_epoch}")
    print("evaluate with: python -m deepim_tpu_torch.tools.track_learned "
          f"--size {h} --prefix {FT_PREFIX} --run-dir {run_dir} --epochs {end_epoch}", flush=True)
    return state


if __name__ == "__main__":
    main()
