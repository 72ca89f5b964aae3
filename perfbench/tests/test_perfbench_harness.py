"""The harness is driven by data: a configuration, a cell or a per-layer
metric is added as new files, with no edit to a file already there."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.tests.tiny import tiny_cell


def _copy(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_cell_and_config_as_files_run(tmp_path):
    root = _copy(tmp_path)
    cfg = json.loads((root / "configs" / "lm6d_ape.json").read_text())
    cfg["meshes"]["diameter_mm"] = [108.999]  # the duck
    (root / "configs" / "lm6d_duck.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "refine_b32.json").read_text())
    tr["z_m"] = [0.8, 1.2]
    (root / "traffic" / "refine_far.json").write_text(json.dumps(tr))
    (root / "workloads" / "lm6d_duck.refine_far.json").write_text(
        json.dumps({"config": "lm6d_duck", "traffic": "refine_far", "chips": 1}))
    cell = tiny_cell("lm6d_duck.refine_far", root=root)
    assert (cell.config_name, cell.traffic_name, cell.kind) == ("lm6d_duck", "refine_far", "refine")
    result, ctx, checks = harness.driver(cell).run(cell, 5, 0.0, False, time.time(), device="cpu")
    assert result["correct"] and set(ctx["end_to_end"]) == {"refine_frames_s", "refine_p95_ms", "setup_s"}


def test_new_per_layer_metric_as_a_file(tmp_path):
    root = _copy(tmp_path)
    (root / "metrics" / "calls_s.py").write_text(
        "def read(ctx):\n    return ctx['calls'] / ctx['window_s'] if 'calls' in ctx else None\n")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_s.refine", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "host driver", "moves": "refine_frames_s"})
    bfile = tmp_path / "BENCHMARK.json"
    bfile.write_text(json.dumps(bench))
    names = harness.per_layer_metrics("lm6d_ape.refine_b32", ["refine_frames_s", "refine_p95_ms", "setup_s"], bfile)
    assert "calls_s.refine" in names and "mfu.train" not in names
    ctx = {"calls": 10, "window_s": 2.0}
    units = harness.metric_units(bfile)
    got = harness.read_metrics(["calls_s.refine", "idle_share.refine"], ctx, units, root)
    # A reader with nothing to read (no trace) leaves its metric out.
    assert got == {"calls_s.refine": {"value": 5.0, "unit": "1/s"}}


def test_no_card_exits_nonzero_without_a_result():
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "lm6d_ape.refine_b32",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_puts_checks_last(capsys):
    harness.emit({"correct": True, "attempted": 3, "failed": 0, "metrics": {}, "device": {}},
                 [("pose_gap", 0.01, 0.05)])
    captured = capsys.readouterr()
    line = captured.out.strip().splitlines()[-1]
    assert list(json.loads(line))[-1] == "checks"
    assert captured.err.strip().splitlines()[-1].startswith("check pose_gap = 0.01 (limit 0.05, ok)")


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json")))
def test_cell_runs_on_the_card(card, name):
    # A short run of every cell at its real size prints a correct result
    # line with the contract's keys.
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", name, "--seed",
                          str(2**31 + 11), "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                         timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line) and line["correct"]
    assert line["device"]["platform"] == "gpu" and "setup_s" in line["metrics"]
