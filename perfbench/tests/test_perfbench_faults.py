"""`correct` comes out false when the timed path is broken underneath:
each fault a cell can have, planted in the program at 64x64 on the CPU,
the rest of the run as the harness drives it (the look for a card
skipped).  And the control (the reference in float8 in the program's
place) comes out not correct under the same run, reading farther from the
reference than the program does."""
from __future__ import annotations

import importlib
import time

import pytest
import torch

from perfbench import control, harness
from perfbench.reference import deepim as ref
from perfbench.reference.net import QUANT
from perfbench.tests.tiny import tiny_cell
from perfbench.yardstick import inputs


def _run(cell, seed=2**31 + 41):
    result, _, checks = harness.driver(cell).run(cell, seed, 0.0, False, time.time(), device="cpu")
    return result, checks


def _refine_module():
    # The module, not the package's `refine` function of the same name.
    return importlib.import_module("deepim_tpu_torch.engine.refine")


def _refine_fault(kind):
    real = _refine_module().refine

    def broken(model, obs, meshes, pose0, ecfg, **kw):
        pose, poses = real(model, obs, meshes, pose0, ecfg, **kw)
        if kind == "state_unchanged":
            poses = pose0.expand_as(poses).clone()
        elif kind == "half_batch":
            poses = poses.clone()
            poses[:, poses.shape[1] // 2:] = pose0[poses.shape[1] // 2:]
        elif kind == "answer_altered":
            poses = poses.clone()
            poses[-1, 0, :, 3] += torch.tensor([0.01, 0.0, 0.0])
        return poses[-1], poses

    return broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_refine_fault_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(_refine_module(), "refine", _refine_fault(kind))
    result, checks = _run(tiny_cell("lm6d_ape.refine_b32"))
    assert not result["correct"], checks


def _train_fault(kind, make):
    from deepim_tpu_torch.engine.train import TrainBatch

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(state, batch, bank):
            if kind == "state_unchanged":
                before = [p.detach().clone() for p in state.model.parameters()]
                state, metrics, pose = step(state, batch, bank)
                with torch.no_grad():
                    for p, b in zip(state.model.parameters(), before):
                        p.copy_(b)
                state.optimizer.inner.state.clear()
                return state, metrics, pose
            if kind == "half_batch":
                half = batch.image_observed.shape[0] // 2
                batch = TrainBatch(*(x if x is None or name == "k" else x[:half]
                                     for name, x in zip(TrainBatch._fields, batch)))
                return step(state, batch, bank)
            state, metrics, pose = step(state, batch, bank)
            metrics = dict(metrics)
            metrics["pm_loss"] = metrics["pm_loss"] * torch.tensor([1.1, 1.0, 1.0, 1.0])
            return state, metrics, pose

        return broken

    return make_broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_train_fault_is_not_correct(monkeypatch, kind):
    import deepim_tpu_torch.engine.train as train

    monkeypatch.setattr(train, "make_train_step", _train_fault(kind, train.make_train_step))
    result, checks = _run(tiny_cell("lm6d_ape.train_b16"))
    assert not result["correct"], checks


def _capture_build(monkeypatch, drv):
    """Keep the set-up's inputs (`build`'s dict) where the control can find them."""
    seen = {}
    real = drv.build

    def build(cell, seed, dev):
        seen.update(real(cell, seed, dev))
        return seen

    monkeypatch.setattr(drv, "build", build)
    return seen


def _assert_control_fails(result, checks, program):
    # Not correct, and not only because 64x64 on the CPU is not the cell's
    # size: some number reads at least 3x what the program reads there.
    assert not result["correct"], checks
    assert max(c[1] / max(p[1], 1e-12) for c, p in zip(checks, program)) >= 3.0, (checks, program)


def test_refine_control_is_not_correct(monkeypatch):
    # The reference in float8 in the program's place: the timed call
    # returns its poses, the harness judges them.
    cell = tiny_cell("lm6d_ape.refine_b32")
    drv = harness.driver(cell)
    s = _capture_build(monkeypatch, drv)

    def control_refine(model, obs, meshes, pose0, ecfg, **kw):
        b = next(b for b in s["batches"] if b["pose0"] is pose0)
        spec = inputs.spec_to(s["spec"], pose0.device)
        poses = ref.refine(s["weights"], spec, b["mesh"], b["image_observed"], pose0, ecfg.num_iters,
                           QUANT[control.CONTROL])
        return poses[-1], poses

    _, program = _run(cell)
    monkeypatch.setattr(_refine_module(), "refine", control_refine)
    monkeypatch.setattr(harness, "driver", lambda c: drv)
    result, checks = _run(cell)
    _assert_control_fails(result, checks, program)


def test_train_control_is_not_correct(monkeypatch):
    # The reference's float8 training step in the program's place: its
    # losses returned as the step's, its parameters and momentum written
    # into the program's state, where the harness reads them.
    import deepim_tpu_torch.engine.train as train

    cell = tiny_cell("lm6d_ape.train_b16")
    drv = harness.driver(cell)
    s = _capture_build(monkeypatch, drv)

    def make_control(*args, **kwargs):
        opt = {}

        def control_step(state, batch, bank):
            named = dict(state.model.named_parameters())
            if not opt:
                spec = inputs.spec_to(s["spec"], batch.pose_rendered.device)
                params = {n: p.detach().float().clone().requires_grad_(True) for n, p in named.items()}
                opt["sgd"] = ref.SGD(params, spec)
            sgd = opt["sgd"]
            b = next(b for b in s["batches"] if b["pose0"] is batch.pose_rendered)
            parts = ref.train_call(sgd, sgd.spec, b["mesh"], b, sgd.spec["iters_train"], QUANT[control.CONTROL])
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(sgd.params[n])
                    state.optimizer.inner.state[p]["momentum_buffer"] = sgd.buf[n].clone()
            return state, parts, batch.pose_rendered

        return control_step

    _, program = _run(cell)
    monkeypatch.setattr(train, "make_train_step", make_control)
    monkeypatch.setattr(harness, "driver", lambda c: drv)
    result, checks = _run(cell)
    _assert_control_fails(result, checks, program)


@pytest.mark.parametrize("name", ["lm6d_ape.refine_b32", "lm6d_ape.train_b16"])
def test_control_reads_farther_than_the_program(name):
    cell = tiny_cell(name)
    reading = {"refine": control.refine_reading, "train": control.train_reading}[cell.kind]
    dev = torch.device("cpu")
    prog = reading(cell, 2**31 + 3, dev, False)
    ctl = reading(cell, 2**31 + 3, dev, True)
    assert max(ctl[k] / max(prog[k], 1e-12) for k in prog) >= 3.0, (prog, ctl)
