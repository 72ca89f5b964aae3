"""The occlusion benchmark (counterpart of experiments/benchmark_occlusion.py):
the synthetic accuracy benchmark's checkpoint evaluated on multi-instance
scenes of the same procedural classes (every scene holds every class at
jittered nearby positions, so the objects occlude each other, as in
Occlusion-LINEMOD), each class seeing only its own visible pixels of the
shared frame (its id in the scene's label image).  By default the
checkpoint is first fine-tuned on occlusion training scenes, with flow
supervision only where the flow target lands on the object's visible
pixels (FLOW_WEIGHT_TYPE viz_visible).

Run after tools.benchmark_multiclass with the same --size, --classes,
--subdiv and --out:

    python -m deepim_tpu_torch.tools.benchmark_occlusion [--epochs 60] [--n-scenes 32]
        [--train-scenes 256] [--finetune-epochs 40] [--out <multiclass devkit>] [--device cuda|cpu]

The multiclass run's checkpoint <out>/run/bench13_ckpt/<epochs> is copied
to <out>_occ<train>_<scenes>/run/occ13_ckpt/<epochs> and the fine-tune
resumes from it.  It prints one "BENCH_OCC_JSON {...}" line and a markdown
table; main returns the table with the run's figures.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np

from deepim_tpu_torch.config import Config, update_config_dict
from deepim_tpu_torch.engine.checkpoint import checkpoint_path, load_checkpoint
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.render.mesh import make_benchmark_classes
from deepim_tpu_torch.render.rasterizer import RasterConfig
from deepim_tpu_torch.tools.benchmark_multiclass import (
    PREFIX,
    benchmark_k,
    default_devkit,
    fresh_results,
    init_pose_rows,
    print_epochs,
    print_run,
)
from deepim_tpu_torch.tools.synth_data import generate_occlusion_dataset
from deepim_tpu_torch.tools.train_net import build_model, train_net

FT_PREFIX = "occ13"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Occlusion benchmark of the 13-class checkpoint (PyTorch port)")
    ap.add_argument("--epochs", type=int, default=60, help="checkpoint epoch to load")
    ap.add_argument("--n-scenes", type=int, default=32)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--classes", type=int, default=13)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--train-scenes", type=int, default=256,
                    help="occlusion training scenes (0 = zero-shot eval of the single-object checkpoint)")
    ap.add_argument("--finetune-epochs", type=int, default=40)
    ap.add_argument("--train-iter-size", type=int, default=4,
                    help="4 = the reference's RFMx4 protocol: the network fine-tunes on its own "
                    "iterated-mask distribution")
    ap.add_argument("--resume-epoch", type=int, default=0,
                    help="resume the fine-tune from this epoch's checkpoint (> --epochs), for a run split "
                    "into chunks of epochs, each a process of its own")
    ap.add_argument("--train-only", action="store_true", help="train (or resume) and exit before evaluation")
    ap.add_argument("--ft-mask", default="box_rendered", choices=["box_rendered", "box_gt"],
                    help="fine-tune INIT/UPDATE mask strategy; box_rendered is what the test loop feeds the "
                    "network after iteration 1")
    ap.add_argument("--out", default=None,
                    help="the multiclass run's devkit (its --out; default: under the temp directory); the "
                    "occlusion devkit goes beside it")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def occlusion_config(args: argparse.Namespace, occ_devkit: str, classes: list[str], k: np.ndarray) -> Config:
    """The JAX runner's test config for these flags, field for field."""
    h = w = args.size
    return update_config_dict(Config(), {
        "SCALES": [h, w],
        "output_path": os.path.join(occ_devkit, "output"),
        "dataset": {
            "dataset": "LM6D_REFINE", "dataset_path": occ_devkit, "root_path": occ_devkit,
            "image_set": "train_", "test_image_set": "val_",
            "model_dir": os.path.join(occ_devkit, "models"),
            "class_name": classes,
            "INTRINSIC_MATRIX": k.flatten().tolist(),
            "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True,
                    "PIXEL_MEANS": [123.68, 116.779, 103.939]},
        "TEST": {"test_iter": 4, "test_epoch": args.epochs, "FAST_TEST": False, "UPDATE_MASK": "box_rendered",
                 "INIT_MASK": "box_rendered"},
    })


def finetune_config(args: argparse.Namespace, cfg: Config) -> Config:
    """The JAX runner's fine-tune config over the test config."""
    return update_config_dict(cfg, {
        "network": {"TRAIN_ITER": True, "TRAIN_ITER_SIZE": args.train_iter_size},
        "train_iter": {
            "SE3_PM_LOSS": True, "LW_PM": 1.0, "NUM_3D_SAMPLE": 512, "LW_FLOW": 0.25,
            "LW_MASK": 0.01 * (128.0 / args.size) ** 2,  # area-scaled, as in benchmark_multiclass
        },
        "TRAIN": {
            "optimizer": "adam", "BATCH_PAIRS": args.batch,
            "warmup": True, "warmup_lr": 1e-5, "warmup_step": 50,
            "lr": 1e-4, "lr_step": f"{args.epochs + args.finetune_epochs * 3 // 4}",
            "grad_clip": 1.0,
            "INIT_MASK": args.ft_mask, "UPDATE_MASK": args.ft_mask,
            "MASK_DILATE": True, "model_prefix": FT_PREFIX,
            "CHECKPOINT_INTERVAL": 5,
            "RESUME": True,
            "begin_epoch": max(args.epochs, args.resume_epoch),
            "end_epoch": args.epochs + args.finetune_epochs,
            # Flow supervision only where the target lands on this object's
            # visible pixels: occluder pixels are no correspondence.
            "FLOW_WEIGHT_TYPE": "viz_visible",
        },
    })


def main(argv: list[str] | None = None) -> dict | None:
    """Generate the occlusion devkit (if absent), fine-tune from the
    multiclass checkpoint (or load it with --train-scenes 0), test and
    print the tables.  Returns {'table', 'epochs' (the fine-tune's
    per-epoch figures), 'run' (test_deepim's), 'generation': {'scenes',
    'seconds'}}, or None with --train-only."""
    t_start = time.perf_counter()
    args = parse_args(argv)
    h = w = args.size
    k = benchmark_k(h, w)
    train_devkit = args.out or default_devkit(args.classes, h, args.subdiv)
    # The scene counts are baked into the devkit: key its directory on them.
    occ_devkit = train_devkit + f"_occ{args.train_scenes}_{args.n_scenes}"
    meshes = make_benchmark_classes(args.classes, subdiv=args.subdiv)
    classes = sorted(meshes.keys())
    generation = {"scenes": 0, "seconds": 0.0}
    if not os.path.exists(os.path.join(occ_devkit, "image_set")):
        print("generating occlusion scenes at", occ_devkit, flush=True)
        t0 = time.perf_counter()
        # Spread so that objects overlap partly rather than pile up: at
        # z ~0.65 m the view's half-width is ~0.24 m, the diameters 0.07-0.19 m.
        generate_occlusion_dataset(occ_devkit, meshes, k, n_scenes=args.train_scenes + args.n_scenes,
                                   n_train=args.train_scenes, height=h, width=w, z_range=(0.55, 0.75),
                                   lateral_spread=0.1,
                                   raster_cfg=RasterConfig(height=h, width=w, znear=0.05, zfar=10.0),
                                   device=args.device)
        generation = {"scenes": args.train_scenes + args.n_scenes, "seconds": time.perf_counter() - t0}

    cfg = occlusion_config(args, occ_devkit, classes, k)
    run_dir = os.path.join(train_devkit, "run")
    out_dir = os.path.join(occ_devkit, "run")
    os.makedirs(out_dir, exist_ok=True)
    epochs = []
    if args.train_scenes:
        # Fine-tune on occlusion scenes: the multiclass checkpoint seeds the
        # fine-tune's checkpoint stream, which then resumes.
        end_epoch = args.epochs + args.finetune_epochs
        seed_dst = checkpoint_path(os.path.join(out_dir, FT_PREFIX), args.epochs)
        if not os.path.exists(seed_dst):
            os.makedirs(os.path.dirname(seed_dst), exist_ok=True)
            shutil.copyfile(checkpoint_path(os.path.join(run_dir, PREFIX), args.epochs), seed_dst)
        state = train_net(finetune_config(args, cfg), output_dir=out_dir, device=args.device)
        print_epochs(state.epochs)
        if args.train_only:
            print("train-only: stopped after epoch", end_epoch, flush=True)
            return None
        cfg = update_config_dict(cfg, {"TEST": {"test_epoch": end_epoch}})
        model, epochs = state.model, state.epochs
    else:
        model = build_model(cfg, device=args.device)
        load_checkpoint(os.path.join(run_dir, PREFIX), args.epochs, TrainState(model, None))
    results = fresh_results(cfg, out_dir, model, args.batch, args.device)

    # The initial poses' accuracy over the same pairs.
    init_rows = init_pose_rows(cfg, classes, k)
    init_row = {key: float(np.mean(init_rows[key])) for key in ("ADD<0.1d", "Proj2D@5px")}
    table = [
        {
            "ADD<0.1d": float(np.mean([results["add"][c][it]["0.10"] for c in classes])),
            "ADD auc": float(np.mean([results["add"][c][it]["auc"] for c in classes])),
            "Proj2D@5px": float(np.mean([results["arp_2d"][c][it]["5"] for c in classes])),
            "Proj2D auc": float(np.mean([results["arp_2d"][c][it]["auc"] for c in classes])),
        }
        for it in range(cfg.TEST.test_iter)
    ]
    print("\nBENCH_OCC_JSON " + json.dumps({"init": init_row, "iters": table}))
    print("\n==== Occlusion README table (mean over %d classes, %d scenes) ====" % (len(classes), args.n_scenes))
    print("| iter | ADD(-S)<0.1d | ADD AUC | Proj2D@5px | Proj2D AUC |")
    print("|---|---|---|---|---|")
    print("| init | %.1f | - | %.1f | - |" % (init_row["ADD<0.1d"], init_row["Proj2D@5px"]))
    for it, row in enumerate(table):
        print("| %d | %.1f | %.1f | %.1f | %.1f |" % (it + 1, row["ADD<0.1d"], row["ADD auc"], row["Proj2D@5px"],
                                                       row["Proj2D auc"]))
    print_run(generation, epochs, results.get("run", {}), time.perf_counter() - t_start)
    return {"table": {"init": init_row, "iters": table}, "epochs": epochs, "run": results.get("run", {}),
            "generation": generation}


if __name__ == "__main__":
    main()
