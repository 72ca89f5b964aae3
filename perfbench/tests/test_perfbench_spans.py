"""The readers of the program's spans (`program_span` metrics): on the
CPU, calls of the tiny refine cell traced under torch.profiler, as a
`--trace 1` run traces them; on the card, a short traced run of each cell
reports them."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_cell

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]
QUANTITIES = sorted({name.split(".")[0] for name in SPAN_METRICS})
DEVICE = {"render_span_ms", "zoom_span_ms", "net_span_ms"}


@pytest.fixture(scope="module")
def traced():
    """Three calls of the tiny refine cell under a CPU profiler, then two
    more: the registry holds five calls, each reader is given n of them."""
    from torch.profiler import ProfilerActivity, profile

    from deepim_tpu_torch.engine.refine import refine
    from deepim_tpu_torch.utils import tracing

    cell = tiny_cell("lm6d_ape.refine_b32")
    dev = torch.device("cpu")
    s = harness.driver(cell).build(cell, 2**31 + 17, dev)

    def call(i):
        obs, mesh, pose0 = s["calls"][i % len(s["calls"])]
        refine(s["model"], obs, mesh, pose0, s["ecfg"], device=dev)

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            call(i)
    readings = {n: {q: _reader(q).read({"trace": {"calls": n}}) for q in QUANTITIES} for n in (1, 2, 3)}
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(2):
            call(i)
    kept = tracing.calls()
    tracing.reset()
    return readings, kept


def _reader(quantity: str):
    return harness.load_module(harness.HERE / "metrics" / f"{quantity}.py")


def test_fourteen_metrics_seven_readers():
    assert len(SPAN_METRICS) == 14 and len(QUANTITIES) == 7
    for name in SPAN_METRICS:
        assert harness.reader(name) == harness.HERE / "metrics" / f"{name.split('.')[0]}.py"


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_reader_reads_nothing_without_a_trace(quantity):
    assert _reader(quantity).read({}) is None
    assert _reader(quantity).read({"calls": 4, "window_s": 1.0}) is None


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_reader_takes_the_first_calls(traced, quantity):
    readings, kept = traced
    from deepim_tpu_torch.utils import tracing

    assert len(kept) == 5 and all(c["name"] == "refine.call" for c in kept)
    if quantity in DEVICE:
        # The CPU has no device events.
        assert all(readings[n][quantity] is None for n in readings)
        return
    names = {"render_host_ms": ("render",), "zoom_host_ms": ("zoom",),
             "net_host_ms": ("net.forward", "net.backward")}
    for n in (1, 2, 3):
        got = readings[n][quantity]
        assert got > 0
        if quantity == "driver_host_ms":
            want = tracing.layer_ms(kept[:n], ("render", "zoom", "net.forward", "net.backward"), outside=True)
        else:
            want = tracing.layer_ms(kept[:n], names[quantity])
        assert got == pytest.approx(want, rel=1e-12)
    assert readings[1][quantity] != readings[2][quantity]


def test_host_readings_split_the_call(traced):
    # The three layers and the driver's rest add up to the whole call.
    readings, kept = traced
    total = sum(readings[3][q] for q in ("render_host_ms", "zoom_host_ms", "net_host_ms", "driver_host_ms"))
    whole = sum(c["spans"][0]["host_ms"] for c in kept[:3]) / 3
    assert total == pytest.approx(whole, rel=1e-9)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json")))
def test_traced_run_reports_the_span_metrics(card, name):
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", name, "--seed",
                          str(2**31 + 23), "--seconds", "2", "--trace", "1"], capture_output=True, text=True,
                         timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    want = harness.per_layer_metrics(name, [m["name"] for m in BENCH["end_to_end"]
                                            if name in m.get("workloads", [name])])
    for metric in (m for m in SPAN_METRICS if m in want):
        assert metrics[metric]["value"] > 0, metric
