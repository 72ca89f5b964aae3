"""Parity with the JAX package of the pieces A1's chained protocols and the
learning check use (engine/checkpoint.py's merge_matching_params through
tools/benchmark_multiclass.py --seed-convs, tools/synthetic_sanity.py), on
the CPU, and tools/a1_protocol.sh's chain of runner calls.

Tolerances: every tensor exact.  The weights are seeded numpy values in
the JAX model's parameter tree (shapes from eval_shape, no compile),
carried across by the weight converter (state_dict_from_flax); the
harnesses' Configs field for field."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.engine.checkpoint as j_checkpoint  # noqa: E402
import deepim_tpu.tools.train_net as j_train_net  # noqa: E402
from deepim_tpu.models.flownet import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu_torch.config import Config  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from deepim_tpu_torch.engine.train import TrainState  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.models.flownet import FlowNetDeepIM  # noqa: E402
from deepim_tpu_torch.tools import benchmark_multiclass as t_bm  # noqa: E402
from deepim_tpu_torch.tools import synthetic_sanity as t_ss  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _drop_tmp_files(tmp_path):
    """The tests write network checkpoints of ~150 MB: removed as each ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_runner(name: str):
    """experiments/<name>.py as a module (a script, not a package module)."""
    spec = importlib.util.spec_from_file_location(f"j_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_SS = _jax_runner("synthetic_sanity")


def _tree(hw, seed: int) -> dict:
    """The JAX network's parameter tree at `hw` (8 input channels, flow and
    mask heads) filled with seeded values."""
    shapes = jax.eval_shape(JFlowNet(pred_flow=True, pred_mask=True).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 8)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, np.float32) * np.float32(0.02), shapes)


def _model(hw, state: dict) -> FlowNetDeepIM:
    """An 8-channel port network at `hw` holding copies of `state`."""
    model = FlowNetDeepIM(in_channels=8, input_hw=hw, device="meta")
    model.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
    return model


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


class _Stop(Exception):
    pass


# -- the seeded 480x640 run: merge_matching_params through --seed-convs ----------------------

def test_seeded_init_equals_jax_merge(tmp_path, monkeypatch):
    """benchmark_multiclass --seed-convs at another frame size hands
    train_net the weights JAX's merge_matching_params makes of the same
    fresh and checkpoint weights, exactly: every tensor the checkpoint's
    but fc6's weight, whose input size scales with the frame and which
    keeps the fresh draw on both sides (its bias, of the same shape at any
    size, is seeded on both).  The checkpoint is read from
    <prefix>_ckpt/<epoch>, and the run prints what it kept fresh."""
    lo, hi = (64, 64), (64, 128)
    base, fresh = _tree(lo, seed=1), _tree(hi, seed=2)
    j_merged, j_skipped = j_checkpoint.merge_matching_params(fresh, base)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, j_merged))
    assert j_skipped == ["['params']['fc6']['kernel']"]

    prefix = str(tmp_path / "base_256" / "run" / t_bm.PREFIX)
    save_checkpoint(prefix, 30, TrainState(_model(lo, state_dict_from_flax(base)), None))
    fresh_state = state_dict_from_flax(fresh)
    monkeypatch.setattr(t_bm, "build_model", lambda cfg, device="cuda": _model((cfg.height, cfg.width), fresh_state))
    got = {}

    def train_net(cfg, output_dir=None, device="cuda", init_state_dict=None):
        got["init"], got["cfg"] = init_state_dict, cfg
        raise _Stop

    monkeypatch.setattr(t_bm, "train_net", train_net)
    devkit = tmp_path / "hires"
    (devkit / "image_set").mkdir(parents=True)
    with contextlib.redirect_stdout(io.StringIO()) as buf, pytest.raises(_Stop):
        t_bm.main(["--size", "64", "--width", "128", "--classes", "2", "--subdiv", "1", "--train-iter-size", "4",
                   "--out", str(devkit), "--seed-convs", prefix, "--seed-epoch", "30", "--train-only",
                   "--device", "cpu"])
    assert f"seeded convs from {prefix} epoch 30 (fresh: fc6.weight)" in buf.getvalue()
    _assert_state_equal(got["init"], want)
    assert torch.equal(got["init"]["fc6.weight"], fresh_state["fc6.weight"])
    assert got["cfg"].TRAIN.RESUME is False and (got["cfg"].height, got["cfg"].width) == hi


# -- synthetic_sanity ------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--overfit", "--epochs", "8", "--size", "64"]], ids=["defaults", "overfit"])
def test_synthetic_sanity_config_equals_jax(tmp_path, flags, monkeypatch):
    """synthetic_sanity hands train_net the Config JAX's main() hands its
    train_net, field for field, for the same flags (an existing devkit, so
    neither generates one)."""
    out = tmp_path / "devkit"
    (out / "image_set").mkdir(parents=True)
    got = {}

    def capture(key):
        def stop(cfg, *args, **kwargs):
            got[key] = cfg
            raise _Stop
        return stop

    monkeypatch.setattr(j_train_net, "train_net", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["synthetic_sanity.py", *flags, "--out", str(out)])
    with pytest.raises(_Stop):
        J_SS.main()
    monkeypatch.setattr(t_ss, "train_net", capture("port"))
    with pytest.raises(_Stop):
        t_ss.main([*flags, "--out", str(out), "--device", "cpu"])
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["jax"])
    assert got["port"].dataset.test_image_set == ("train_" if flags else "val_")
    assert isinstance(got["port"], Config)


def test_synthetic_sanity_runs_on_cpu(tmp_path):
    """One tiny run end to end: finite losses, every class's init and
    refined ADD rows, four iterations."""
    out = t_ss.main(["--size", "64", "--epochs", "1", "--n-train", "8", "--n-val", "2", "--out",
                     str(tmp_path / "devkit"), "--device", "cpu"])
    e, = out["epochs"]
    assert e["nonfinite_losses"] == e["raster_dropped"] == 0 and e["samples"] == 16
    for cls in t_ss.CLASSES:
        row = out["classes"][cls]
        assert len(row["acc"]) == len(row["mean"]) == 4
        assert np.isfinite([row["init_acc"], row["init_mean"], *row["acc"], *row["mean"]]).all()


# -- tools/a1_protocol.sh ----------------------------------------------------------------------

FAKE_PYTHON = '''#!{python}
"""Stands in for python: records each `-u -m <module> ...` call; a
--train-only chunk saves a checkpoint every 5 epochs and at its last, and
stops early (exit 124, as under timeout) past $FAKE_STOP_<name>."""
import json, os, sys
args = sys.argv[1:]
if args[0] == "-c":
    print("3.12 fake fake")
    sys.exit(0)
mod, rest = args[2], args[3:]
with open(os.environ["FAKE_CALLS"], "a") as f:
    f.write(json.dumps([mod, *rest]) + "\\n")
flag = lambda name: rest[rest.index(name) + 1] if name in rest else None
if "--train-only" in rest:
    epochs = int(flag("--epochs"))
    stop = int(os.environ.get("FAKE_STOP_" + flag("--out").rsplit("/", 1)[1], epochs))
    ckpt = os.path.join(flag("--out"), "run", "bench13_ckpt")
    for e in range(int(flag("--resume-epoch") or 0) + 1, min(epochs, stop) + 1):
        if e % 5 == 0 or e == epochs:
            os.makedirs(os.path.join(ckpt, str(e)))
        print("epoch %d: fake" % e)
    sys.exit(0 if stop >= epochs else 124)
print("BENCH13_JSON {{}}")
'''

A1_BASE = ["--size", "256", "--classes", "13", "--lr", "2e-4"]
A1_480 = ["--size", "480", "--width", "640", "--train-iter-size", "4", "--classes", "13", "--batch", "16", "--lr",
          "1e-4", "--n-train", "128"]
BM, OCC = "deepim_tpu_torch.tools.benchmark_multiclass", "deepim_tpu_torch.tools.benchmark_occlusion"


@pytest.mark.parametrize("stops", [{}, {"base_256": 27}, {"hires_480x640": 6}], ids=["full", "base_short", "hires_short"])
def test_a1_protocol_chain(tmp_path, stops):
    """a1_protocol.sh calls the runners in JAX's round-5 order with the
    flags tests/test_torch_benchmark.py holds to JAX's (the 256^2 base in
    two chunks, the 480x640 run seeded from its epoch 30 in two 4-epoch
    chunks, its test at epoch 8, then the occlusion fine-tune).  A chunk
    cut short ends the training before it: the next step seeds from, or
    tests, the newest checkpoint, the summary says so, the occlusion step
    is skipped when the base missed epoch 30, and the script exits 1."""
    bin_dir, work, log = tmp_path / "bin", tmp_path / "work", tmp_path / "log"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(FAKE_PYTHON.format(python=sys.executable))
    (bin_dir / "nvidia-smi").write_text("#!/bin/sh\necho 'Fake GPU, 700.00 W'\n")
    for f in bin_dir.iterdir():
        f.chmod(0o755)
    calls = tmp_path / "calls.jsonl"
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "FAKE_CALLS": str(calls),
           **{f"FAKE_STOP_{k}": str(v) for k, v in stops.items()}}
    proc = subprocess.run(["bash", str(REPO / "deepim_tpu_torch" / "tools" / "a1_protocol.sh"), str(log), "3400",
                           str(work)], env=env, capture_output=True, text=True, timeout=60)
    base, hires = str(work / "base_256"), str(work / "hires_480x640")
    seed = 25 if stops.get("base_256") else 30
    tested = 5 if stops.get("hires_480x640") else 8
    want = [
        [BM, *A1_BASE, "--out", base, "--train-iter-size", "2", "--epochs", "15", "--train-only"],
        [BM, *A1_BASE, "--out", base, "--train-iter-size", "4", "--epochs", "30", "--resume-epoch", "15",
         "--train-only"],
        [BM, *A1_480, "--out", hires, "--epochs", "4", "--seed-convs", base + "/run/bench13", "--seed-epoch",
         str(seed), "--train-only"],
        [BM, *A1_480, "--out", hires, "--epochs", "8", "--resume-epoch", "4", "--train-only"],
        [BM, *A1_480, "--out", hires, "--epochs", str(tested), "--test-only"],
    ]
    if "base_256" not in stops:
        want.append([OCC, "--size", "256", "--epochs", "30", "--train-scenes", "256", "--finetune-epochs", "30",
                     "--out", base])
    got = [json.loads(line) for line in calls.read_text().splitlines()]
    assert got == want
    summary = (log / "summary.log").read_text()
    assert summary.startswith("card: Fake GPU, 700.00 W\n") and "BENCH13_JSON {}" in summary
    assert "b_ep8: rc %d" % (124 if stops.get("hires_480x640") else 0) in summary
    if stops.get("base_256"):
        assert "(a) ended at epoch 25: (b) and (c) start from epoch 25, not the protocol's 30" in summary
        assert "c: skipped, (a) did not reach epoch 30" in summary
    if stops.get("hires_480x640"):
        assert "(b) ended at epoch 5: testing epoch 5, not the protocol's 8" in summary
    assert proc.returncode == (1 if stops else 0), proc.stdout + proc.stderr
