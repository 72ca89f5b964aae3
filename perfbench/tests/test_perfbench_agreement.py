"""At 64x64 on the CPU the plain reference agrees with the port's refine
and training step: with the port's network in float32 to float32's
rounding, and in bf16 (as the cells run it) to bf16's."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_cell


def _run(cell, seed=2**31 + 99):
    return harness.driver(cell).run(cell, seed, 0.0, False, time.time(), device="cpu")


@pytest.fixture
def fp32_program(monkeypatch):
    import deepim_tpu_torch.tools.test_net as test_net
    import deepim_tpu_torch.tools.train_net as train_net

    build = train_net.build_model
    monkeypatch.setattr(test_net, "EVAL_DTYPE", torch.float32)
    monkeypatch.setattr(train_net, "build_model",
                        lambda cfg, dtype=None, device="cuda": build(cfg, dtype=torch.float32, device=device))


@pytest.mark.parametrize("name", ["lm6d_ape.refine_b32", "lm6d_all.refine_b32"])
def test_refine_fp32_agrees(fp32_program, name):
    cell = tiny_cell(name)
    result, ctx, checks = _run(cell)
    # Poses after every iteration within 1e-4 of the reference's movement
    # (float32 rounding through four renders, zooms and networks).
    assert checks[0][0] == "pose_gap" and checks[0][1] < 1e-4
    # The window makes at least one call a pool batch.
    assert result["correct"] and result["failed"] == 0 and ctx["calls"] == cell.traffic["pool"]


def test_train_fp32_agrees(fp32_program):
    _, _, checks = _run(tiny_cell("lm6d_ape.train_b16"))
    gaps = {name: value for name, value, _ in checks}
    # Losses to float32 rounding; gradients and updates to 1e-3 of a leaf
    # (sums over 64x64 pixels and 3,000 points in another order).
    assert gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-3 and gaps["change_gap"] < 1e-3


def test_bf16_as_run_close():
    # The cells' own precision at 64x64: within 1% of the refinement's
    # movement and 5% of each loss (the limits of `correct` are set at the
    # cells' sizes on the card, PERF.md section 2).
    _, _, checks = _run(tiny_cell("lm6d_ape.refine_b32"))
    assert checks[0][1] < 0.01
    _, _, checks = _run(tiny_cell("lm6d_ape.train_b16"))
    assert dict((n, v) for n, v, _ in checks)["loss_gap"] < 0.05
