"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs and weights from the seed, builds the
program (deepim_tpu_torch) and warms every shape the cell uses; then the
timed path runs back to back for --seconds; then the program's outputs are
compared with the plain reference (perfbench/reference).  With --trace 0
the result holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics (read from a torch.profiler trace of a few calls made
after the window) and the device's busy and traced seconds.  Exits non-zero
without a result line when there is no CUDA card, too few cards, or a
forbidden module (JAX or the JAX package) is loaded.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    start = harness.process_start()
    import torch

    cell = harness.load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, {torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    units = harness.metric_units()
    result, ctx, checks = harness.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), start)
    if args.trace:
        names = harness.per_layer_metrics(cell.name, list(ctx["end_to_end"]))
        result["metrics"] = harness.read_metrics(names, ctx, units)
    else:
        result["metrics"] = {n: {"value": v, "unit": units[n]} for n, v in ctx["end_to_end"].items()}
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
