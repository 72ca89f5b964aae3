"""Readings from which the limits of `correct` are set, for one cell, in
one process: the program's number on each of --seeds, and the control's
on each of --control-seeds.  The control is the plain reference put in the
program's place and computed in the nearest precision below the
configuration's bf16: every convolution's and dense layer's operands
rounded to float8 e4m3 under a per-tensor scale (perfbench/reference/net.py
fp8_e4m3).

    python3 perfbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 101 102 103

Prints one JSON line a seed ({"who": "program" | "control", "seed", and
the cell's numbers}).  The program runs as in a benchmark run: a warm-up
call, then the compared calls (refine: one a pool batch) or steps
(training: the first `compare_steps`); the reference follows them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference import deepim as ref  # noqa: E402
from perfbench.reference.net import QUANT  # noqa: E402
from perfbench.yardstick import inputs  # noqa: E402

CONTROL = "fp8_e4m3"


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def refine_reading(cell, seed: int, dev, control: bool) -> dict:
    drv = harness.driver(cell)
    s = drv.build(cell, seed, dev)
    if control:
        spec = inputs.spec_to(s["spec"], dev)
        chosen = [(i, ref.refine(s["weights"], spec, b["mesh"], b["image_observed"], b["pose0"],
                                 spec["iters_test"], QUANT[CONTROL])) for i, b in enumerate(s["batches"])]
    else:
        from deepim_tpu_torch.engine.refine import refine

        def call(i):
            obs, mesh, pose0 = s["calls"][i]
            return refine(s["model"], obs, mesh, pose0, s["ecfg"], device=dev)[1]

        call(0)
        chosen = [(i, call(i)) for i in range(len(s["calls"]))]
    s.pop("model"), s.pop("calls")
    _free(dev)
    rms, widest = drv.reference_gap(s, chosen, dev)
    return {"pose_gap": rms, "widest": widest}


def train_reading(cell, seed: int, dev, control: bool) -> dict:
    drv = harness.driver(cell)
    s = drv.build(cell, seed, dev)
    n = cell.traffic["compare_steps"]
    wd, mu = s["cfg"].TRAIN.wd, s["cfg"].TRAIN.momentum
    if control:
        s.pop("state"), s.pop("step")
        _free(dev)
        spec = inputs.spec_to(s["spec"], dev)
        params = {k: w.clone().requires_grad_(True) for k, w in s["weights"].items()}
        opt = ref.SGD(params, spec)
        losses = []
        for i in range(n):
            losses.append(ref.train_call(opt, spec, s["batches"][i]["mesh"], s["batches"][i],
                                         spec["iters_train"], QUANT[CONTROL]))
            if i == 0:
                grad = {k: v.clone() for k, v in opt.buf.items()}
        final = {k: p.detach().clone() for k, p in params.items()}
        del opt, params
    else:
        _, losses, grad, final = drv.first_steps(s, n)
        s.pop("state"), s.pop("step")
    _free(dev)
    gaps = drv.reference_gaps(s, losses, grad, final, n, wd, mu, dev)
    return {**gaps, "leaves": len(grad)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    reading = {"refine": refine_reading, "train": train_reading}[cell.kind]
    for who, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            row = {"who": who, "seed": seed, **reading(cell, seed, dev, who == "control")}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
