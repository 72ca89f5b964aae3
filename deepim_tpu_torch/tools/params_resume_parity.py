"""End-to-end `.params` interop (counterpart of
experiments/params_resume_parity.py): resume training from an exported
reference-format checkpoint and check it against the native path bit for
bit.  The reference fine-tunes a pretrained FlowNet `.params` file with
SGD in every recipe (deepim/train.py:165-195); this runs that loop on a
tiny 2-class devkit:

  1. train 2 classes for 2 epochs with the reference's SGD recipe;
  2. export epoch 2 to deepim-0002.params (mxnet_from_state_dict and
     save_mxnet_params: the mx.nd.save layout, flow_conv1 in BGR, fc6 in
     MXNet's flattening) and, as the control, to deepim-0002.npz
     (save_npz_state_dict);
  3. continue 1 epoch from each through network.pretrained;
  4. check that the two continued runs end with equal parameters (the
     round trip through .params is lossless) and that both moved from the
     seed (the continuation trains).

    python -m deepim_tpu_torch.tools.params_resume_parity [--size 64] [--n-train 32] [--n-val 8]
        [--out <devkit dir>] [--device cuda|cpu]

It prints "INTEROP_JSON {...}" (max_abs_diff_params_vs_npz_resume,
max_abs_drift_from_seed, ok) and exits 1 unless ok; main returns that
dict.  The devkit goes under --out, by default
<tempdir>/interop_2c_<size>.

On CUDA the runs are made under torch.use_deterministic_algorithms, with
cuDNN's deterministic algorithms, so equal inputs give equal parameters;
an op of the path without a deterministic CUDA implementation raises,
naming itself.  cuBLAS reads CUBLAS_WORKSPACE_CONFIG once a process, at its
first call, so it is set before that: by this script when run as one, by a
caller that imports main (chip_smoke.py sets it at its start).  Without
CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import torch

from deepim_tpu_torch.config import Config, update_config_dict
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.engine.checkpoint import read_checkpoint
from deepim_tpu_torch.models.import_mxnet import mxnet_from_state_dict
from deepim_tpu_torch.render.mesh import make_benchmark_classes
from deepim_tpu_torch.render.rasterizer import RasterConfig
from deepim_tpu_torch.tools.benchmark_multiclass import benchmark_k
from deepim_tpu_torch.tools.convert_mxnet_checkpoint import save_npz_state_dict
from deepim_tpu_torch.tools.synth_data import generate_dataset
from deepim_tpu_torch.tools.train_net import train_net
from deepim_tpu_torch.utils.mxnet_io import save_mxnet_params

def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=".params training-resume interop check (PyTorch port)")
    ap.add_argument("--size", type=int, default=64, help="frame height and width")
    ap.add_argument("--n-train", type=int, default=32, help="train pairs per class")
    ap.add_argument("--n-val", type=int, default=8, help="val pairs per class")
    ap.add_argument("--out", default=None, help="devkit and run directory (default: under the temp directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def parity_config(devkit: str, classes: list[str], size: int, out_dir: str, prefix: str, end_epoch: int,
                  pretrained: str = "") -> Config:
    """The JAX harness's config, field for field: the reference's SGD
    fine-tune recipe (deepim/train.py:260-292: momentum 0.975, weight
    decay, warmup, multifactor lr)."""
    k = benchmark_k(size, size)
    return update_config_dict(Config(), {
        "SCALES": [size, size],
        "output_path": out_dir,
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
            "TRAIN_ITER": True, "TRAIN_ITER_SIZE": 2,
            "PIXEL_MEANS": [123.68, 116.779, 103.939],
            "pretrained": pretrained,
        },
        "train_iter": {
            "SE3_PM_LOSS": True, "LW_PM": 1.0, "NUM_3D_SAMPLE": 64,
            "LW_FLOW": 0.25, "LW_MASK": 0.01,
        },
        "TRAIN": {
            "optimizer": "sgd", "momentum": 0.975, "wd": 0.0005,
            "BATCH_PAIRS": 8, "end_epoch": end_epoch,
            "warmup": True, "warmup_lr": 1e-6, "warmup_step": 4,
            "lr": 1e-5, "lr_step": "10",
            "grad_clip": 1.0,
            "INIT_MASK": "box_gt", "UPDATE_MASK": "box_gt",
            "MASK_DILATE": True, "model_prefix": prefix,
        },
    })


@contextlib.contextmanager
def deterministic(dev: torch.device):
    """On CUDA: torch's deterministic algorithms and cuDNN's, without
    benchmarking; the previous settings come back on exit.  Nothing on the
    CPU."""
    if dev.type != "cuda":
        yield
        return
    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]


def max_abs_diff(a: dict, b: dict) -> float:
    """The largest absolute difference between two state_dicts' tensors."""
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def main(argv: list[str] | None = None) -> dict:
    """Run the four stages, print INTEROP_JSON and return its three keys."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h = w = args.size
    devkit = args.out or os.path.join(tempfile.gettempdir(), f"interop_2c_{h}")
    meshes = make_benchmark_classes(2, subdiv=2)
    classes = sorted(meshes)
    if not os.path.exists(os.path.join(devkit, "image_set")):
        generate_dataset(devkit, meshes, benchmark_k(h, w), n_train=args.n_train, n_val=args.n_val, height=h,
                         width=w, z_range=(0.45, 0.75),
                         raster_cfg=RasterConfig(height=h, width=w, znear=0.05, zfar=10.0), device=dev)

    def make_cfg(out_dir, prefix, end_epoch, pretrained=""):
        return parity_config(devkit, classes, h, out_dir, prefix, end_epoch, pretrained)

    with deterministic(dev):
        run_a = os.path.join(devkit, "run_seed")
        print("== stage 1: seed training (2 epochs, SGD) ==", flush=True)
        train_net(make_cfg(run_a, "interop", 2), output_dir=run_a, device=dev)
        seed = read_checkpoint(os.path.join(run_a, "interop"), 2)["model"]
        mx_path = os.path.join(devkit, "deepim-0002.params")
        npz_path = os.path.join(devkit, "deepim-0002.npz")
        save_mxnet_params(mx_path, mxnet_from_state_dict(seed, input_hw=(h, w), rgb_to_bgr=True))
        save_npz_state_dict(npz_path, seed)
        print("== stage 2: exported", mx_path, flush=True)

        def continued(tag, path):
            out = os.path.join(devkit, "run_from_" + tag)
            print(f"== stage 3: continue 1 epoch from {os.path.basename(path)} ==", flush=True)
            state = train_net(make_cfg(out, "cont", 1, pretrained=path), output_dir=out, device=dev)
            return {k: v.detach().cpu() for k, v in state.model.state_dict().items()}

        finals = {tag: continued(tag, path) for tag, path in (("params", mx_path), ("npz", npz_path))}

    worst = max_abs_diff(finals["params"], finals["npz"])
    moved = max_abs_diff(finals["params"], seed)
    ok = worst == 0.0 and moved > 0.0
    result = {"max_abs_diff_params_vs_npz_resume": worst, "max_abs_drift_from_seed": moved, "ok": bool(ok)}
    print("INTEROP_JSON " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(0 if main()["ok"] else 1)
