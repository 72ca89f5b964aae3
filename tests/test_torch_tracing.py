"""The port's span registry (deepim_tpu_torch/utils/tracing.py) on the
CPU: off by default at the cost of a flag check, the spans of a 64x64
refine call and of a training step with their parents, calls and self
times, the spans under a torch.profiler session, the Chrome-trace export,
the eval driver's stage timers against its spans, and the --trace-out
switch of both drivers.  No JAX: the registry has no JAX counterpart."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from deepim_tpu_torch.config import Config, TrainConfig, TrainIterConfig, update_config_dict
from deepim_tpu_torch.engine.lr_schedule import warmup_multifactor_schedule
from deepim_tpu_torch.engine.refine import Observation, refine
from deepim_tpu_torch.engine.scene import build_scene, train_batch
from deepim_tpu_torch.engine.train import TrainState, make_optimizer, make_train_step
from deepim_tpu_torch.models import FlowNetDeepIM
from deepim_tpu_torch.render.mesh import make_icosphere, make_test_cube
from deepim_tpu_torch.render.rasterizer import RasterConfig
from deepim_tpu_torch.tools import test_net, train_net
from deepim_tpu_torch.tools.synth_data import generate_dataset
from deepim_tpu_torch.utils import tracing

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
ITERS = 4
ITER_SPANS = ("render", "zoom", "net.forward", "pose.update")
TRAIN_SPANS = ("render", "zoom", "net.forward", "pose.update", "loss", "net.backward", "optim.step")


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def scene():
    sc = build_scene(2, H, W, K64, num_iters=ITERS, device="cpu")
    model = FlowNetDeepIM(input_hw=(H, W), pred_flow=False, pred_mask=False, device="cpu").eval()
    obs = Observation(sc.image, sc.mask, None, None, torch.from_numpy(K64))
    return sc, model, obs


def _refine(scene):
    sc, model, obs = scene
    return refine(model, obs, sc.meshes, torch.from_numpy(sc.pose0), sc.ecfg, device="cpu")


@pytest.fixture(scope="module")
def refine_call(scene):
    tracing.reset()
    tracing.enable()
    try:
        _refine(scene)
        kept = tracing.calls()
    finally:
        tracing.disable()
        tracing.reset()
    assert len(kept) == 1
    return kept[0]


@pytest.fixture(scope="module")
def train_call():
    sc = build_scene(2, H, W, K64, num_iters=2, update_mask="box_gt", device="cpu")
    batch = train_batch(sc, K64, 16)
    model = FlowNetDeepIM(input_hw=(H, W), device="cpu")
    state = TrainState(model, make_optimizer(model.parameters(), TrainConfig(),
                                             warmup_multifactor_schedule(1e-4, (10_000,))))
    ticfg = TrainIterConfig(SE3_PM_LOSS=True, LW_PM=0.1, NUM_3D_SAMPLE=16, LW_FLOW=0.25, LW_MASK=0.03)
    step = make_train_step(sc.ecfg, ticfg, "viz", device="cpu")
    tracing.reset()
    tracing.enable()
    try:
        step(state, batch, sc.bank_arrays)
        kept = tracing.calls()
    finally:
        tracing.disable()
        tracing.reset()
    assert len(kept) == 1
    return kept[0]


def _children(call: dict, parent_id: int) -> list[dict]:
    return [s for s in call["spans"] if s["parent"] == parent_id]


def test_off_span_is_one_shared_context():
    assert not tracing.is_on()
    a, b = tracing.span("render"), tracing.span("zoom", torch.device("cpu"))
    assert a is b
    with a as got:
        assert got is None
    tracing.count("loader.batches")
    assert tracing.calls() == [] and tracing.totals() == {} and tracing.snapshot()["counters"] == {}


def test_off_refine_calls_nothing_in_torch(scene, monkeypatch):
    """With tracing off a refine call makes no record_function call and no
    CUDA event, and leaves the registry empty."""
    def refuse(*args, **kwargs):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _refine(scene)
    assert tracing.calls() == [] and tracing.totals() == {}


def test_refine_call_is_one_call(refine_call):
    root = refine_call["spans"][0]
    assert refine_call["name"] == root["name"] == "refine.call"
    assert root["parent"] is None and root["call"] == root["id"] == refine_call["id"]
    assert all(s["call"] == root["id"] for s in refine_call["spans"])
    assert len({s["id"] for s in refine_call["spans"]}) == len(refine_call["spans"])
    iters = _children(refine_call, root["id"])
    assert [s["name"] for s in iters] == ["refine.iter"] * ITERS
    # The CPU has no device interval.
    assert all(s["device_ms"] is None and s["device_start_ns"] is None for s in refine_call["spans"])


@pytest.mark.parametrize("name", ITER_SPANS)
def test_refine_iteration_holds_each_layer(refine_call, name):
    root = refine_call["spans"][0]
    for it in _children(refine_call, root["id"]):
        kids = _children(refine_call, it["id"])
        assert [s["name"] for s in kids] == list(ITER_SPANS)
        (s,) = [k for k in kids if k["name"] == name]
        assert it["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"] <= it["host_end_ns"]
        assert s["host_ms"] > 0


@pytest.mark.parametrize("name", ["render.bin", "render.raster"])
def test_render_holds_binning_and_raster(refine_call, name):
    renders = [s for s in refine_call["spans"] if s["name"] == "render"]
    assert len(renders) == ITERS
    for r in renders:
        assert [s["name"] for s in _children(refine_call, r["id"])] == ["render.bin", "render.raster"]
    assert sum(s["name"] == name for s in refine_call["spans"]) == ITERS


@pytest.mark.parametrize("which", ["refine", "train"])
def test_self_time_is_duration_less_children(refine_call, train_call, which):
    call = refine_call if which == "refine" else train_call
    for s in call["spans"]:
        kids = _children(call, s["id"])
        assert s["host_self_ms"] == pytest.approx(s["host_ms"] - sum(k["host_ms"] for k in kids), abs=1e-6)
        assert 0 <= s["host_self_ms"] <= s["host_ms"]


@pytest.mark.parametrize("name", TRAIN_SPANS)
def test_train_step_spans(train_call, name):
    root = train_call["spans"][0]
    assert train_call["name"] == "train.step" and root["parent"] is None
    inner = _children(train_call, root["id"])
    assert [s["name"] for s in inner] == ["train.inner"] * 2
    for it in inner:
        names = [s["name"] for s in _children(train_call, it["id"])]
        assert names.count(name) == 1, names
    assert names == list(TRAIN_SPANS)


def test_totals_add_up(scene):
    tracing.enable()
    _refine(scene)
    _refine(scene)
    kept = tracing.calls()
    tot = tracing.totals()
    assert len(kept) == 2 and tot["refine.call"]["count"] == 2 and tot["render"]["count"] == 2 * ITERS
    for name in ("refine.call",) + ITER_SPANS:
        spans = [s for c in kept for s in c["spans"] if s["name"] == name]
        assert tot[name]["host_ms"] == pytest.approx(sum(s["host_ms"] for s in spans), rel=1e-9)
        assert tot[name]["host_self_ms"] == pytest.approx(sum(s["host_self_ms"] for s in spans), rel=1e-9)
        assert tot[name]["device_ms"] is None
    render = tracing.layer_ms(kept, ("render",))
    assert render == pytest.approx(tot["render"]["host_ms"] / 2)
    outside = tracing.layer_ms(kept, ("render", "zoom", "net.forward"), outside=True)
    assert outside == pytest.approx((tot["refine.call"]["host_ms"] - tot["render"]["host_ms"] - tot["zoom"]["host_ms"]
                                     - tot["net.forward"]["host_ms"]) / 2)
    assert tracing.layer_ms(kept, ("render",), "device") is None and tracing.layer_ms([], ("render",)) is None


def test_profiler_turns_spans_on(scene):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.is_on()
        _refine(scene)
    assert not tracing.is_on()
    kept = tracing.calls()
    assert [c["name"] for c in kept] == ["refine.call"]
    annotated = {e.name for e in prof.events() if e.is_user_annotation}
    assert {s["name"] for s in kept[0]["spans"]} <= annotated
    # Nothing is recorded once the session has ended.
    _refine(scene)
    assert len(tracing.calls()) == 1


@pytest.mark.parametrize("case", ["reentrant", "ring", "counters"])
def test_registry_rules(case, monkeypatch):
    tracing.enable()
    if case == "reentrant":
        with tracing.span("refine.call"):
            with tracing.span("refine.call"):
                with tracing.span("render"):
                    pass
        (call,) = tracing.calls()
        assert [s["name"] for s in call["spans"]] == ["refine.call", "render"]
    elif case == "ring":
        monkeypatch.setattr(tracing, "MAX_CALLS", 3)
        for _ in range(5):
            with tracing.span("train.step"):
                with tracing.span("loss"):
                    pass
        kept = tracing.calls()
        assert len(kept) == 3 and [c["id"] for c in kept] == sorted(c["id"] for c in kept)
        assert tracing.totals()["train.step"]["count"] == 5 and tracing.totals()["loss"]["count"] == 5
    else:
        with tracing.span("loader.batch"):
            tracing.count("loader.batches")
            with tracing.span("inner"):
                tracing.count("loader.batches", 2)
        tracing.count("loader.batches")
        (call,) = tracing.calls()
        assert [s["counters"] for s in call["spans"]] == [{"loader.batches": 1}, {"loader.batches": 2}]
        snap = tracing.snapshot()
        assert snap["counters"] == {"loader.batches": 4}
        assert set(snap["raster_launches"]) == {"csr_raster", "csr_planes_raster", "tile_raster"}


def test_threads_keep_their_own_calls():
    """Eight threads, more than the cores the tests get, open nested spans
    and count under a short switch interval: every span, count and call
    survives, each call on its own thread."""
    import sys
    import threading

    n_threads, n_calls = 8, 50

    def work():
        for _ in range(n_calls):
            with tracing.span("loader.batch"):
                tracing.count("loader.batches")
                with tracing.span("inner"):
                    tracing.count("inner.count")

    tracing.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    total = n_threads * n_calls
    assert snap["totals"]["loader.batch"]["count"] == snap["totals"]["inner"]["count"] == total
    assert snap["counters"] == {"loader.batches": total, "inner.count": total}
    kept = tracing.calls()
    assert len(kept) == min(total, tracing.MAX_CALLS)
    for call in kept:
        outer, inner = call["spans"]
        assert inner["parent"] == outer["id"] == inner["call"] and inner["thread"] == outer["thread"]
        assert outer["counters"] == {"loader.batches": 1} and inner["counters"] == {"inner.count": 1}


def test_write_chrome_trace(scene, tmp_path):
    tracing.enable()
    _refine(scene)
    with tracing.span("loader.batch"):
        tracing.count("loader.batches")
    path = tmp_path / "sub" / "trace.json"
    tracing.write(str(path))
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} >= {"refine.call", "refine.iter", "render", "loader.batch"}
    assert all(e["dur"] >= 0 and e["cat"] == "host" for e in spans)
    lanes = [e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"]
    assert lanes and all(n.split()[0] in ("host", "device") for n in lanes)
    (batch,) = [e for e in spans if e["name"] == "loader.batch"]
    assert batch["args"]["loader.batches"] == 1
    assert doc["otherData"]["totals"]["refine.call"]["count"] == 1


# -- the drivers ------------------------------------------------------------------

@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("LM6d_refine_tracing"))
    generate_dataset(path, {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 1)}, K64,
                     n_train=2, n_val=3, height=H, width=W, z_range=(0.45, 0.6),
                     raster_cfg=RasterConfig(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                             chunk=16, znear=0.05, zfar=10.0), device="cpu")
    return path


def _cfg_dict(devkit_path, out):
    return {
        "SCALES": [H, W],
        "output_path": str(out),
        "dataset": {
            "dataset": "LM6D_REFINE", "dataset_path": devkit_path, "root_path": devkit_path,
            "image_set": "train_", "test_image_set": "val_",
            "model_dir": os.path.join(devkit_path, "models"), "class_name": ["cube", "sphere"],
            "INTRINSIC_MATRIX": K64.flatten().tolist(), "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True, "TRAIN_ITER": True,
                    "TRAIN_ITER_SIZE": 2, "PIXEL_MEANS": [123.68, 116.779, 103.939]},
        "train_iter": {"SE3_PM_LOSS": True, "LW_PM": 0.1, "NUM_3D_SAMPLE": 16, "LW_FLOW": 0.25, "LW_MASK": 0.03},
        "TRAIN": {"BATCH_PAIRS": 2, "end_epoch": 1, "lr": 1e-4, "INIT_MASK": "box_gt", "UPDATE_MASK": "box_gt",
                  "FLOW_WEIGHT_TYPE": "viz", "model_prefix": "deepim_synth"},
        "TEST": {"test_iter": 2, "test_epoch": 1, "FAST_TEST": True},
    }


def test_eval_stage_timers_match_spans(devkit, tmp_path):
    """pred_eval's data_s / net_s equal the traced loader.wait /
    refine.call spans' host totals up to the spans' own entry and exit."""
    cfg = update_config_dict(Config(), _cfg_dict(devkit, tmp_path / "out"))
    tracing.enable()
    res = test_net.test_deepim(cfg, output_dir=str(tmp_path / "run"), batch_size=2, device="cpu")
    run = res["run"]
    tot = tracing.snapshot()
    for span, stage in (("loader.wait", "data_s"), ("refine.call", "net_s")):
        gap = run[stage] * 1e3 - tot["totals"][span]["host_ms"]
        assert 0 <= gap <= 2.0 + 0.02 * run[stage] * 1e3, (span, stage, gap)
    # Two classes of 3 pairs in batches of 2: 4 batches, each waited for
    # once, and one end-of-class wait a class.
    assert tot["totals"]["refine.call"]["count"] == 4 and tot["totals"]["loader.wait"]["count"] == 6
    assert tot["counters"]["loader.batches"] == 4 and tot["totals"]["loader.batch"]["count"] == 4
    assert run["pairs"] == 6


def _yaml(d: dict, indent: str = "") -> str:
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines += [f"{indent}{k}:", _yaml(v, indent + "  ")]
        elif isinstance(v, list):
            lines.append(f"{indent}{k}: [{', '.join(str(x) for x in v)}]")
        elif isinstance(v, bool):
            lines.append(f"{indent}{k}: {'true' if v else 'false'}")
        elif isinstance(v, str):
            lines.append(f'{indent}{k}: "{v}"')
        else:
            lines.append(f"{indent}{k}: {v!r}")
    return "\n".join(lines)


@pytest.mark.parametrize("tool", ["test_net", "train_net"])
def test_trace_out_flag(devkit, tmp_path, tool):
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(_yaml(_cfg_dict(devkit, tmp_path / "out")) + "\n")
    out = tmp_path / "trace" / f"{tool}.json"
    mod = test_net if tool == "test_net" else train_net
    argv = ["--cfg", str(cfg_file), "--device", "cpu", "--trace-out", str(out)]
    mod.main(argv + (["--batch-size", "2"] if tool == "test_net" else []))
    assert not tracing.is_on()
    with open(out) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    want = {"loader.wait", "loader.batch", "refine.call", "render", "net.forward"}
    if tool == "train_net":
        want = {"loader.wait", "loader.batch", "train.step", "train.inner", "loss", "net.backward", "optim.step"}
    assert want <= names, names
    assert doc["otherData"]["counters"]["loader.batches"] >= 2
