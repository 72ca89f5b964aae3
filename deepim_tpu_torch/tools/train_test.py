"""Train, then test (counterpart of experiments/deepim/deepim_train_test.py):

    python -m deepim_tpu_torch.tools.train_test --cfg <experiment.yaml> [--device cuda|cpu]
        [--test-only] [--batch-size 16]

runs train_net and then test_deepim on the trained network; --test-only
runs test_deepim alone, from the checkpoint of TEST.test_epoch.  Without
CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse

from deepim_tpu_torch.config import load_config
from deepim_tpu_torch.device import set_explicit_precision
from deepim_tpu_torch.tools.test_net import test_deepim
from deepim_tpu_torch.tools.train_net import train_net


def main(argv: list[str] | None = None) -> dict:
    """The CLI: train_net then test_deepim, both bf16.  The card's
    precision is set explicitly (set_explicit_precision) before the first
    network is built."""
    ap = argparse.ArgumentParser(description="Train and test DeepIM (PyTorch port)")
    ap.add_argument("--cfg", required=True, help="experiment YAML file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--test-only", action="store_true")
    ap.add_argument("--batch-size", type=int, default=16, help="test batch")
    args = ap.parse_args(argv)
    cfg = load_config(args.cfg)
    set_explicit_precision()
    model = None if args.test_only else train_net(cfg, device=args.device).model
    return test_deepim(cfg, batch_size=args.batch_size, device=args.device, model=model)


if __name__ == "__main__":
    main()
