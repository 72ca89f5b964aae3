"""The port's configuration layer against the JAX package's and PyYAML on
the CPU: the YAML-subset reader, load_config field by field, strict keys
and validate_config, EngineConfig.from_config (with the bank-tuned CSR
budget), the run-directory logger and checkpoints.  All comparisons are
exact."""
import dataclasses
import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import load_config as j_load_config  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.config import validate_config as j_validate  # noqa: E402
from deepim_tpu.engine.refine import EngineConfig as JEngineConfig  # noqa: E402
from deepim_tpu.render.mesh import MeshBank as JMeshBank  # noqa: E402
from deepim_tpu.render.mesh import make_icosphere as j_icosphere  # noqa: E402
from deepim_tpu.render.mesh import make_test_cube as j_cube  # noqa: E402
from deepim_tpu_torch.config import Config, load_config, update_config_dict, validate_config  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import (  # noqa: E402
    checkpoint_path,
    latest_epoch,
    load_checkpoint,
    merge_matching_params,
    save_checkpoint,
)
from deepim_tpu_torch.engine.refine import EngineConfig  # noqa: E402
from deepim_tpu_torch.engine.train import TrainState, make_optimizer  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM  # noqa: E402
from deepim_tpu_torch.utils.logger import create_logger, logger  # noqa: E402
from deepim_tpu_torch.utils.yaml_subset import YAMLSubsetError, load_file, loads  # noqa: E402

torch.set_num_threads(2)

CFG_FILES = sorted(str(p) for p in (REPO / "experiments" / "deepim" / "cfgs").glob("*.yaml"))


@pytest.mark.parametrize("path", CFG_FILES, ids=os.path.basename)
def test_yaml_subset_equals_pyyaml(path):
    with open(path) as f:
        assert load_file(path) == yaml.safe_load(f)


def test_yaml_subset_scalars_equal_pyyaml():
    """Every scalar form of the subset resolves as YAML 1.1 does."""
    text = (
        "# comment\n"
        "a: 1\nb: -3\nc: 0.00001\nd: 1.5e-05\ne: .5\nf: 2.\ng: true\nh: False\ni: null\nj: ~\nk:\n"
        "l: plain string  # trailing comment\nm: \"quoted # not a comment\"\nn: 'it''s'\n"
        "o: [1, 'a, b', [2, 3.5], null, \"q\"]\np: []\nq: [[480, 640]]\nr: a:b\ns: train_+train_\n"
        "t:\n  u:\n    v: 4\n  w: x\ny: 2\n"
    )
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,match", [
    ("a: &anchor 1\nb: 2\n", "anchor"),
    ("a: 1\nb: *anchor\n", "anchor"),
    ("a: |\n  line one\n  line two\n", "block scalar"),
    ("a: >\n  folded\n", "block scalar"),
    ("a: first line\n  continues here\n", "multi-line"),
    ("a: \"open\n  close\"\n", "multi-line"),
    ("a:\n\tb: 1\n", "tab"),
    ("a:\n  - 1\n  - 2\n", "block sequence"),
    ("a: {b: 1}\n", "flow mapping"),
    ("a: [1, 2\n", "multi-line"),
    ("a: [[[1]]]\n", "nested deeper"),
    ("a: yes\n", "boolean"),
    ("a: 1e-5\n", "number form"),
    ("a: 012\n", "number form"),
    ("a: 1:30\n", "number form"),
    ("a: 1\na: 2\n", "duplicate"),
    ("---\na: 1\n", "document"),
    ("a: !!str 1\n", "tag"),
    ("a:\n    b: 1\n  c: 2\n", "indentation"),
])
def test_yaml_subset_raises_outside_subset(text, match):
    """Input outside the subset raises with the line, never a guess."""
    with pytest.raises(YAMLSubsetError, match=match) as err:
        loads(text, source="cfg.yaml")
    assert "cfg.yaml:" in str(err.value)


@pytest.mark.parametrize("path", CFG_FILES, ids=os.path.basename)
def test_load_config_equals_jax(path):
    """load_config gives the JAX package's Config field by field."""
    t, j = load_config(path), j_load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.height, t.width) == (j.height, j.width) == (480, 640)
    np.testing.assert_array_equal(t.dataset.intrinsic_matrix(), j.dataset.intrinsic_matrix())
    for section in ("network", "dataset", "TRAIN", "TEST", "train_iter"):
        assert [f.name for f in dataclasses.fields(getattr(t, section))] == \
            [f.name for f in dataclasses.fields(getattr(j, section))], section


@pytest.mark.parametrize("overrides", [
    {"no_such_key": 1},
    {"dataset": {"no_such_field": 1}},
    {"TEST": {"FAST": True}},
])
def test_unknown_keys_raise_in_both(overrides):
    for update, cfg in ((update_config_dict, Config()), (j_update, JConfig())):
        with pytest.raises(ValueError, match="does not exist"):
            update(cfg, overrides)


@pytest.mark.parametrize("overrides", [
    {"network": {"ROT_TYPE": "AXIS"}},
    {"network": {"ROT_COORD": "WORLD"}},
    {"network": {"TRAIN_ITER_SIZE": 4}},
    {"network": {"ROT_TYPE": "EULER"}, "train_iter": {"SE3_DIST_LOSS": True}},
    {"TRAIN": {"optimizer": "rmsprop"}},
    {"TRAIN": {"FLOW_WEIGHT_TYPE": "some"}},
    {"train_iter": {"SE3_PM_LOSS": True}},
])
def test_validate_config_raises_in_both(overrides):
    for update, validate, cfg in ((update_config_dict, validate_config, Config()),
                                  (j_update, j_validate, JConfig())):
        with pytest.raises(ValueError):
            validate(update(cfg, overrides))


def test_class_name_file_and_scales(tmp_path):
    names = tmp_path / "classes.txt"
    names.write_text("ape\nduck\n")
    d = {"SCALES": [96, 128], "default": {"frequent": 20},
         "dataset": {"class_name_file": str(names), "trans_stds": [0.1, 0.2, 0.3]}}
    t, j = update_config_dict(Config(), d), j_update(JConfig(), d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.dataset.class_name == ("ape", "duck") and (t.height, t.width) == (96, 128)


@pytest.mark.parametrize("train", [False, True])
def test_engine_config_from_config_equals_jax(train):
    """EngineConfig.from_config with a bank (CSR 20,480-face sphere and a
    cube) for the CPU equals the JAX package's on the CPU, tuned CSR budget
    and float32 image zoom included; for CUDA it differs only in its bf16
    image zoom (the JAX package's accelerator choice)."""
    cfg_d = {"network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True, "TRAIN_ITER": True,
                         "TRAIN_ITER_SIZE": 3, "PIXEL_MEANS": [123.68, 116.779, 103.939]},
             "dataset": {"NORMALIZE_FLOW": 20.0, "trans_stds": [0.5, 0.5, 1.0]},
             "TEST": {"test_iter": 4, "MASK_DILATE": True}, "TRAIN": {"UPDATE_MASK": "box_gt"}}
    bank = JMeshBank.from_meshes([j_cube(0.08), j_icosphere(0.05, 5)])
    arrays = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
    t = EngineConfig.from_config(update_config_dict(Config(), cfg_d), train=train, bank_arrays=arrays,
                                 device="cpu")
    j = JEngineConfig.from_config(j_update(JConfig(), cfg_d), train=train, bank_arrays=arrays)
    assert t.raster.csr_tiers and t.raster.bin_pairs
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cuda = EngineConfig.from_config(update_config_dict(Config(), cfg_d), train=train, bank_arrays=arrays,
                                    device="cuda")
    assert cuda == dataclasses.replace(t, zoom_dtype="bfloat16")


def test_create_logger_layout(tmp_path):
    run_dir = create_logger(str(tmp_path), "prefix", "val_")
    assert run_dir == os.path.join(str(tmp_path), "prefix", "val_")
    logger.info("a line for the run log")
    handlers = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    try:
        logs = list(Path(run_dir).glob("log_*.txt"))
        assert len(logs) == 1
        for h in handlers:
            h.flush()
        assert "a line for the run log" in logs[0].read_text()
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


def _small_model(seed, heads=True):
    return FlowNetDeepIM(input_hw=(64, 64), pred_flow=heads, pred_mask=heads,
                         generator=torch.Generator().manual_seed(seed), device="cpu")


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint / load_checkpoint restore the model, the optimizer's
    state and the step; a model whose parameters the file lacks, or a file
    with parameters the model lacks (unless allowed), raises."""
    from deepim_tpu_torch.config import TrainConfig

    prefix = str(tmp_path / "run" / "deepim")
    model = _small_model(0)
    opt = make_optimizer(model.parameters(), TrainConfig(), lambda c: 1e-3)
    out = model(torch.rand(1, 8, 64, 64))
    (out["rot"].sum() + out["trans"].sum() + out["flow"].sum()).backward()
    opt.step()
    assert latest_epoch(prefix) is None
    save_checkpoint(prefix, 3, TrainState(model, opt, 7))
    save_checkpoint(prefix, 5, TrainState(model, None, 9))
    assert latest_epoch(prefix) == 5 and os.path.isfile(checkpoint_path(prefix, 3))

    fresh = _small_model(1)
    fresh_opt = make_optimizer(fresh.parameters(), TrainConfig(), lambda c: 1e-3)
    state = load_checkpoint(prefix, 3, TrainState(fresh, fresh_opt))
    assert state.step == 7 and fresh_opt.count == opt.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    mom = [fresh_opt.inner.state[p]["momentum_buffer"] for p in fresh.parameters()]
    assert all(torch.equal(a, opt.inner.state[p]["momentum_buffer"]) for a, p in zip(mom, model.parameters()))

    fast = _small_model(2, heads=False)
    with pytest.raises(RuntimeError, match="unexpected"):
        load_checkpoint(prefix, 5, TrainState(fast, None))
    dropped = set(model.state_dict()) - set(fast.state_dict())
    load_checkpoint(prefix, 5, TrainState(fast, None), allow_unexpected=dropped)
    assert torch.equal(fast.fc6.weight, model.fc6.weight)
    save_checkpoint(prefix, 6, TrainState(fast, None))
    with pytest.raises(RuntimeError, match="missing"):
        load_checkpoint(prefix, 6, TrainState(_small_model(3), None))
    with pytest.raises(RuntimeError, match="optimizer"):
        load_checkpoint(prefix, 5, TrainState(_small_model(3), fresh_opt))


def test_merge_matching_params():
    """Entries whose name and shape match are taken; fc6, sized by the
    input resolution, keeps the fresh values."""
    fresh = FlowNetDeepIM(input_hw=(64, 64), pred_flow=False, pred_mask=False, device="cpu").state_dict()
    loaded = FlowNetDeepIM(input_hw=(96, 128), pred_flow=False, pred_mask=False, device="cpu").state_dict()
    merged, skipped = merge_matching_params(fresh, loaded)
    assert skipped == ["fc6.weight"]
    assert torch.equal(merged["fc6.weight"], fresh["fc6.weight"])
    assert torch.equal(merged["convs.conv2.weight"], loaded["convs.conv2.weight"])
