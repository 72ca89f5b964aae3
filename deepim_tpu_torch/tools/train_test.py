"""Train, then test (counterpart of experiments/deepim/deepim_train_test.py):

    python -m deepim_tpu_torch.tools.train_test --cfg <experiment.yaml> [--device cuda|cpu]
        [--test-only] [--batch-size 16]

runs train_net and then test_deepim on the trained network; --test-only
runs test_deepim alone, from the checkpoint of TEST.test_epoch.  Without
CUDA it raises unless given --device cpu.  The multi-GPU front door:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepim_tpu_torch.tools.train_test --cfg <experiment.yaml>

trains data-parallel over N ranks, one card each (NCCL; gloo with
--device cpu), then rank 0 alone tests the trained network and returns the
results; the other ranks return None.  (A multi-process run of the JAX
package has every process compute the same tables.)
"""
from __future__ import annotations

import argparse

from deepim_tpu_torch.config import load_config
from deepim_tpu_torch.device import set_explicit_precision
from deepim_tpu_torch.parallel import initialize_distributed, make_mesh, shutdown_distributed
from deepim_tpu_torch.tools.test_net import test_deepim
from deepim_tpu_torch.tools.train_net import train_net


def main(argv: list[str] | None = None) -> dict | None:
    """The CLI: train_net then test_deepim, both bf16.  The card's
    precision is set explicitly (set_explicit_precision) before the first
    network is built.  Under torch.distributed.run it joins the process
    group first (initialize_distributed) and leaves it at the end; ranks
    other than 0 train and return None without testing."""
    ap = argparse.ArgumentParser(description="Train and test DeepIM (PyTorch port)")
    ap.add_argument("--cfg", required=True, help="experiment YAML file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--test-only", action="store_true")
    ap.add_argument("--batch-size", type=int, default=16, help="test batch")
    args = ap.parse_args(argv)
    owns_group = initialize_distributed(device=args.device)
    try:
        cfg = load_config(args.cfg)
        set_explicit_precision()
        mesh = make_mesh(device=args.device)
        model = None if args.test_only else train_net(cfg, device=args.device).model
        if mesh.rank != 0:
            return None
        return test_deepim(cfg, batch_size=args.batch_size, device=args.device, model=model)
    finally:
        if owns_group:
            shutdown_distributed()


if __name__ == "__main__":
    main()
