"""What every cell shares: finding a cell's files by name, the process's
start, the card check, the per-layer metric readers and the result line.

A cell `perfbench/workloads/<name>.json` names its configuration
(`perfbench/configs/<config>.json`) and its traffic
(`perfbench/traffic/<traffic>.json`); the traffic's `kind` names its driver
(`perfbench/drivers/<kind>.py`, a `run(cell, seed, seconds, trace)`).  A
per-layer metric `<name>` of BENCHMARK.json is read by the `read(ctx)` of
`perfbench/metrics/<name>.py`, or where there is none of
`perfbench/metrics/<quantity>.py`, the quantity being the name up to its
first dot (`idle_share.refine` and `idle_share.train` share
`idle_share.py`).  A reader returns a number, or None when the run has
nothing for it to read; BENCHMARK.json's `workloads` of the metric say
which cells report it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules no process that prints a result may hold: the JAX stack, the
# JAX package and its harnesses (compared by whole top-level name).
FORBIDDEN = ("jax", "jaxlib", "flax", "deepim_tpu", "bench", "__graft_entry__")


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict     # perfbench/configs/<config>.json
    traffic_name: str
    traffic: dict    # perfbench/traffic/<traffic>.json
    chips: int = 1
    root: Path = HERE

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def program_config(self):
        """The configuration as the program reads it (its Config)."""
        from deepim_tpu_torch.config import Config, update_config_dict, validate_config

        return validate_config(update_config_dict(Config(), self.config["config"]))


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> Cell:
    w = _read(root / "workloads" / f"{name}.json")
    return Cell(name, w["config"], _read(root / "configs" / f"{w['config']}.json"), w["traffic"],
                _read(root / "traffic" / f"{w['traffic']}.json"), w.get("chips", 1), root)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(cell.root / "drivers" / f"{cell.kind}.py")


def process_start() -> float:
    """The process's start on time.time()'s clock (Linux: /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer_metrics(cell_name: str, end_to_end: list[str], bench_file: Path = ROOT / "BENCHMARK.json") -> list[str]:
    """BENCHMARK.json's per-layer metrics this cell reports: those listing
    it, and those without a list that move one of its end-to-end metrics."""
    names = []
    for m in _read(bench_file)["per_layer"]:
        cells = m.get("workloads")
        if (cell_name in cells) if cells is not None else (m["moves"] in end_to_end):
            names.append(m["name"])
    return names


def reader(name: str, root: Path = HERE) -> Path:
    own = root / "metrics" / f"{name}.py"
    return own if own.exists() else root / "metrics" / f"{name.split('.')[0]}.py"


def read_metrics(names: list[str], ctx: dict, units: dict, root: Path = HERE) -> dict:
    out = {}
    for name in names:
        value = load_module(reader(name, root)).read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def metric_units(bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    b = _read(bench_file)
    return {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def emit(result: dict, checks: list) -> None:
    """The last lines of standard error (each number compared and its
    limit), then the result line, its `checks` key last."""
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r}, {'ok' if value <= limit else 'FAILED'})",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(line), flush=True)
