"""Training cells: the step from deepim_tpu_torch.engine.train.make_train_step
(TRAIN_ITER_SIZE render-and-update iterations a call) on
TrainState(build_model(cfg), make_optimizer(...)), the full bf16 network
with its flow and mask heads, EngineConfig.from_config(cfg, train=True)
with the mesh bank.

Set-up builds the one state and drives it through `compare_steps` steps
on distinct pool batches, recording their losses, the optimizer's state
after the first and the parameters after the last; the window then goes on
with that same state.  After the window the plain reference follows the
same steps from the same initial weights.

Traffic keys read here besides the generator's: `compare_steps`,
`profile_calls` and the limits `loss_gap`, `grad_gap` and `change_gap`.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench import harness
from perfbench.reference import deepim as ref
from perfbench.reference import net as ref_net
from perfbench.reference.render import render
from perfbench.yardstick import compare, flops, inputs, meshes, trace, work

EPOCH_SIZE = 10_000  # updates an epoch for the lr steps (epochs 4 and 6): beyond any run


def build(cell, seed: int, dev):
    from deepim_tpu_torch.device import set_explicit_precision
    from deepim_tpu_torch.engine.lr_schedule import lr_steps_from_config, warmup_multifactor_schedule
    from deepim_tpu_torch.engine.refine import EngineConfig
    from deepim_tpu_torch.engine.train import TrainBatch, TrainState, make_optimizer, make_train_step
    from deepim_tpu_torch.tools.train_net import build_model

    set_explicit_precision()
    cfg = cell.program_config()
    spec = inputs.spec_of(cell.config["config"])
    bank, n_vertices = meshes.make_bank(cell.config["meshes"], seed)
    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=bank, device=dev)
    model = build_model(cfg, device="meta")
    shapes = ref_net.param_shapes(8, (spec["height"], spec["width"]), heads=True)
    weights = inputs.make_weights(shapes, seed, dev)
    model.load_state_dict({n: weights[n].clone() for n in model.state_dict()}, assign=True)
    t = cfg.TRAIN
    schedule = warmup_multifactor_schedule(t.lr, lr_steps_from_config(t.lr_step, EPOCH_SIZE), 0.1, t.warmup,
                                           t.warmup_lr, t.warmup_step)
    state = TrainState(model, make_optimizer(model.parameters(), t, schedule))
    step = make_train_step(ecfg, cfg.train_iter, t.FLOW_WEIGHT_TYPE, device=dev)
    batches = inputs.make_batches(spec, bank, n_vertices, cell.traffic, t.BATCH_PAIRS, seed, dev,
                                  points=cfg.train_iter.NUM_3D_SAMPLE)
    k = spec["k"].to(dev)
    feed = [TrainBatch(b["image_observed"], b["mask_observed"], b["mask_gt_observed"], b["depth_gt_observed"],
                       b["pose0"], b["pose_gt"], b["class_index"], b["points_model"], b["points_weights"], k)
            for b in batches]
    bank_d = tuple(torch.from_numpy(a).to(dev) for a in bank)
    return {"cfg": cfg, "spec": spec, "state": state, "step": step, "weights": weights, "batches": batches,
            "feed": feed, "bank": bank_d}


def _named(state) -> dict:
    return dict(state.model.named_parameters())


def first_steps(s: dict, n_steps: int):
    """The state's first n_steps calls, on pool batches 0 .. n_steps - 1:
    (state, each call's losses, the optimizer's momentum buffers after the
    first call, the parameters after the last)."""
    state, step, feed, bank = s["state"], s["step"], s["feed"], s["bank"]
    losses = []
    for i in range(n_steps):
        state, metrics, _ = step(state, feed[i], bank)
        losses.append({n: v.detach().clone() for n, v in metrics.items()})
        if i == 0:
            opt_state = state.optimizer.inner.state
            grad = {n: opt_state[p]["momentum_buffer"].clone() if "momentum_buffer" in opt_state.get(p, {})
                    else torch.zeros_like(p) for n, p in _named(state).items()}
    return state, losses, grad, {n: p.detach().clone() for n, p in _named(state).items()}


def run(cell, seed: int, seconds: float, traced: bool, start: float, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    s = build(cell, seed, dev)
    state, step, feed, bank = s["state"], s["step"], s["feed"], s["bank"]
    spec, tr = s["spec"], cell.traffic
    n_cmp = tr["compare_steps"]
    wd, mu = s["cfg"].TRAIN.wd, s["cfg"].TRAIN.momentum
    n_inner = spec["iters_train"]

    state, prog_losses, prog_grad, prog_params = first_steps(s, n_cmp)
    harness.sync(dev)
    setup_s = time.time() - start

    n, t_start = 0, time.perf_counter()
    failed = 0
    while True:
        state, metrics, _ = step(state, feed[(n_cmp + n) % len(feed)], bank)
        harness.sync(dev)
        n += 1
        failed += int(not torch.isfinite(metrics["total"]).all())
        t1 = time.perf_counter()
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    b = s["cfg"].TRAIN.BATCH_PAIRS
    ctx = {"calls": n, "window_s": window_s,
           "end_to_end": {"train_samples_s": n * b / window_s, "setup_s": setup_s}}
    conv_call, net_call = flops.call_flops((spec["height"], spec["width"]), 8, b, n_inner, train=True)
    ctx.update(conv_flops_call=conv_call, net_flops_call=net_call)
    result = {}
    if traced:
        def one(j):
            # The traced steps go through the pool as the window does.
            nonlocal state
            state, _, _ = step(state, feed[j % len(feed)], bank)

        reading = trace.profile(one, tr["profile_calls"])
        ctx["trace"] = reading
        ctx["host_syncs"] = trace.host_syncs(lambda: one(0))
        # The renders' least time, counted at each traced batch's initial
        # poses for every inner render.
        stats: dict = {}
        for j in range(tr["profile_calls"]):
            batch = s["batches"][j % len(s["batches"])]
            mesh = batch["mesh"]
            for _ in range(n_inner):
                render(mesh["vertices"], mesh["colors"], mesh["faces"], mesh["face_valid"], batch["pose0"],
                       spec["k"].to(dev), spec["height"], spec["width"], spec["znear"], spec["zfar"], stats)
        ctx["raster_bound_s"] = work.raster_bound_s(stats)
        result["breakdown"] = {"device_ops": reading["device_ops"], "idle_gaps": reading["idle_gaps"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, s["state"], s["step"], feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gaps = reference_gaps(s, prog_losses, prog_grad, prog_params, n_cmp, wd, mu, dev)
    checks = [(name, gaps[name], tr[name]) for name in ("loss_gap", "grad_gap", "change_gap")]
    result.update(correct=failed == 0 and all(v <= lim for _, v, lim in checks), attempted=n, failed=failed,
                  device=harness.device_info(cell.chips, peak) if dev.type == "cuda" else {})
    if traced:
        result["device"].update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["wall_s"])
    return result, ctx, checks


def reference_gaps(s: dict, prog_losses, prog_grad, prog_params, n_steps: int, wd: float, mu: float,
                   dev) -> dict:
    """The plain reference from the same initial weights through the same
    n_steps calls; the gaps of compare.py."""
    spec = inputs.spec_to(s["spec"], dev)
    w0 = s["weights"]
    params = {n: w.clone().requires_grad_(True) for n, w in w0.items()}
    opt = ref.SGD(params, spec)
    n_inner = spec["iters_train"]
    decay = wd * sum(mu ** i for i in range(n_inner))
    ref_losses = []
    for i in range(n_steps):
        ref_losses.append(ref.train_call(opt, spec, s["batches"][i]["mesh"], s["batches"][i], n_inner))
        if i == 0:
            ref_grad = {n: opt.buf[n] - decay * w0[n] for n in params}
    keep = compare.kept_leaves(ref_grad)
    grad_p = {n: prog_grad[n] - decay * w0[n] for n in keep}
    change_r = {n: params[n].detach() - w0[n] for n in keep}
    change_p = {n: prog_params[n] - w0[n] for n in keep}
    return {"leaves_kept": len(keep), "loss_gap": compare.loss_gap(prog_losses, ref_losses),
            "grad_gap": compare.leaf_gap(grad_p, ref_grad, keep),
            "change_gap": compare.leaf_gap(change_p, change_r, keep)}
