"""The port's .params training-resume check
(tools/params_resume_parity.py) against the JAX harness
(experiments/params_resume_parity.py) on the CPU: its three Configs (the
seed training and both continuations) field for field, one tiny run
that ends ok, with the continued runs equal bit for bit (difference 0.0)
and moved from the seed, the two exports' imports, and the deterministic
settings it runs under on the card."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import shutil
import sys
import tempfile
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
from deepim_tpu.engine.train import TrainState as JTrainState  # noqa: E402
from deepim_tpu.models.flownet import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.models.flownet import FlowNetDeepIM  # noqa: E402
from deepim_tpu_torch.models.import_mxnet import mxnet_from_state_dict  # noqa: E402
from deepim_tpu_torch.tools import params_resume_parity as t_prp  # noqa: E402
from deepim_tpu_torch.tools.convert_mxnet_checkpoint import save_npz_state_dict  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_model, init_pretrained  # noqa: E402
from deepim_tpu_torch.utils.mxnet_io import save_mxnet_params  # noqa: E402

torch.set_num_threads(2)


spec = importlib.util.spec_from_file_location("j_params_resume_parity", REPO / "experiments" / "params_resume_parity.py")
J_PRP = importlib.util.module_from_spec(spec)
spec.loader.exec_module(J_PRP)


@pytest.fixture(autouse=True)
def _drop_tmp_files(tmp_path):
    """The tests write network checkpoints of ~150 MB: removed as each ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_parity_configs_equal_jax(tmp_path, monkeypatch):
    """The seed run's and both continuations' Configs equal the JAX
    harness's, in order, field for field (train_net, the checkpoint read
    and the network build replaced by seeded weights in the JAX model's
    tree: both harnesses then export, import and compare those)."""
    shapes = jax.eval_shape(JFlowNet(pred_flow=True, pred_mask=True).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 8)))
    rng = np.random.default_rng(18)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, np.float32) * np.float32(0.02), shapes)
    state = state_dict_from_flax(tree)
    devkit = tmp_path / "interop_2c_64"
    (devkit / "image_set").mkdir(parents=True)
    got = {"jax": [], "port": []}

    class Trained:
        params = tree

        def __init__(self):
            self.model = FlowNetDeepIM(in_channels=8, input_hw=(64, 64), device="meta")
            self.model.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)

    def capture(key):
        def train_net(cfg, output_dir=None, device=None, **kwargs):
            got[key].append(cfg)
            return Trained()
        return train_net

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(j_train_net, "train_net", capture("jax"))
    monkeypatch.setattr(j_train_net, "build_model", lambda cfg: (None, tree))
    monkeypatch.setattr(j_checkpoint, "load_checkpoint", lambda prefix, epoch, like: JTrainState(tree, None, 0))
    with contextlib.redirect_stdout(io.StringIO()) as buf, pytest.raises(SystemExit):
        J_PRP.main()  # equal weights everywhere: no drift, so not ok
    assert json.loads(buf.getvalue().split("INTEROP_JSON ")[1])["ok"] is False

    monkeypatch.setattr(t_prp, "train_net", capture("port"))
    monkeypatch.setattr(t_prp, "read_checkpoint", lambda prefix, epoch: {"model": state})
    with contextlib.redirect_stdout(io.StringIO()):
        result = t_prp.main(["--out", str(devkit), "--device", "cpu"])
    assert result["ok"] is False
    assert len(got["port"]) == len(got["jax"]) == 3
    for a, b in zip(got["jax"], got["port"]):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert [c.network.pretrained for c in got["port"]] == ["", str(devkit / "deepim-0002.params"),
                                                          str(devkit / "deepim-0002.npz")]


def test_params_resume_parity_tiny_run(tmp_path):
    """One tiny run on the CPU (64x64, 4 training pairs a class: one step
    an epoch): INTEROP_JSON with the JAX harness's keys, the continuation
    from .params equal to the one from .npz (0.0), both moved from the
    seed."""
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        result = t_prp.main(["--size", "64", "--n-train", "4", "--n-val", "1", "--out", str(tmp_path / "devkit"),
                             "--device", "cpu"])
    printed = json.loads(buf.getvalue().split("INTEROP_JSON ")[1].splitlines()[0])
    assert list(printed) == ["max_abs_diff_params_vs_npz_resume", "max_abs_drift_from_seed", "ok"]
    assert printed["max_abs_diff_params_vs_npz_resume"] == 0.0 and printed["max_abs_drift_from_seed"] > 0.0
    assert printed["ok"] is True and result == printed


def test_exports_import_equal(tmp_path):
    """The seed's two exports (.params through mxnet_from_state_dict and
    save_mxnet_params, .npz through save_npz_state_dict) load through
    network.pretrained into equal weights, bit for bit, equal to the seed."""
    shapes = jax.eval_shape(JFlowNet(pred_flow=True, pred_mask=True).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 8)))
    rng = np.random.default_rng(7)
    seed = state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, np.float32) * np.float32(0.02), shapes))
    mx_path, npz_path = str(tmp_path / "deepim-0002.params"), str(tmp_path / "deepim-0002.npz")
    save_mxnet_params(mx_path, mxnet_from_state_dict(seed, input_hw=(64, 64), rgb_to_bgr=True))
    save_npz_state_dict(npz_path, seed)
    model = None
    for path in (mx_path, npz_path):
        cfg = t_prp.parity_config(str(tmp_path), ["a", "b"], 64, str(tmp_path), "cont", 1, pretrained=path)
        model = model or build_model(cfg, device="cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        init_pretrained(cfg, model)
        got = model.state_dict()
        assert set(got) == set(seed)
        for k in seed:
            assert torch.equal(got[k], seed[k]), (path, k)


@pytest.mark.parametrize("before", [(False, False, False, True), (True, True, True, False)], ids=["off", "warn_only"])
def test_deterministic_settings_restored(before):
    """On a CUDA device the runs are made under torch's deterministic
    algorithms (raising, not warning) and cuDNN's, without benchmarking;
    the settings before come back on exit.  On the CPU nothing changes."""
    def settings():
        return (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)

    old = settings()
    try:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2], before[3]
        with t_prp.deterministic(torch.device("cpu")):
            assert settings() == before
        with t_prp.deterministic(torch.device("cuda")):
            assert settings() == (True, False, True, False)
        assert settings() == before
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old[2], old[3]
