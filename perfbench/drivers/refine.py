"""Refine cells: one closed-loop caller refining batches of detections
back to back through deepim_tpu_torch.engine.refine.refine, the bf16
FAST_TEST network built as tools/test_net.py builds it, the engine config
from EngineConfig.from_config with the mesh bank (the CSR budget sized by
tune_raster_for_bank).

Traffic keys read here besides the generator's: `batch`, `compare_calls`
(calls compared with the reference after the window, drawn from the seed,
one for each pool batch first), `profile_calls` (calls traced with
--trace 1, through the pool) and the limit `pose_gap`.  The window makes
at least one call a pool batch.
"""
from __future__ import annotations

import gc
import importlib
import statistics
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import deepim as ref
from perfbench.reference import net as ref_net
from perfbench.reference.render import render
from perfbench.yardstick import compare, flops, inputs, meshes, trace, work

# Model points a sample for pose_gap: the sample's mesh vertices, strided.
GAP_POINTS = 512


def build(cell, seed: int, dev):
    """Set-up: inputs from the seed, the program's network and engine
    config, the pool as the program's Observation / MeshBuffers."""
    from deepim_tpu_torch.device import set_explicit_precision
    from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation
    from deepim_tpu_torch.tools.test_net import _eval_model

    set_explicit_precision()
    cfg = cell.program_config()
    spec = inputs.spec_of(cell.config["config"])
    bank, n_vertices = meshes.make_bank(cell.config["meshes"], seed)
    ecfg = EngineConfig.from_config(cfg, bank_arrays=bank, device=dev)
    model = _eval_model(cfg)
    shapes = ref_net.param_shapes(8, (spec["height"], spec["width"]), heads=True)
    weights = inputs.make_weights(shapes, seed, dev)
    model.load_state_dict({n: weights[n].clone() for n in model.state_dict()}, assign=True)
    batches = inputs.make_batches(spec, bank, n_vertices, cell.traffic, cell.traffic["batch"], seed, dev)
    k = spec["k"].to(dev)
    calls = [(Observation(b["image_observed"], b["mask_observed"], None, None, k),
              MeshBuffers.gather(bank, b["class_index"].cpu().numpy(), device=dev), b["pose0"]) for b in batches]
    return {"cfg": cfg, "spec": spec, "bank": bank, "ecfg": ecfg, "model": model, "weights": weights,
            "batches": batches, "calls": calls}


def run(cell, seed: int, seconds: float, traced: bool, start: float, device="cuda"):
    program = importlib.import_module("deepim_tpu_torch.engine.refine")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    s = build(cell, seed, dev)
    model, ecfg, calls = s["model"], s["ecfg"], s["calls"]
    spec, tr = s["spec"], cell.traffic
    n_iters = ecfg.num_iters

    def call(i):
        obs, mesh, pose0 = calls[i % len(calls)]
        return program.refine(model, obs, mesh, pose0, ecfg, device=dev)[1]

    for i in range(len(calls)):
        call(i)
    harness.sync(dev)
    setup_s = time.time() - start

    outputs, lat = [], []
    t_start = time.perf_counter()
    n = 0
    while True:
        t0 = time.perf_counter()
        outputs.append(call(n))
        harness.sync(dev)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        n += 1
        if t1 - t_start >= seconds and n >= len(calls):
            break
    window_s = t1 - t_start
    b = tr["batch"]
    ctx = {"calls": n, "window_s": window_s, "end_to_end": {
        "refine_frames_s": n * b / window_s,
        "refine_p95_ms": statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3 if n > 1 else lat[0] * 1e3,
        "setup_s": setup_s}}
    conv_call, net_call = flops.call_flops((spec["height"], spec["width"]), 8, b, n_iters, train=False)
    ctx.update(conv_flops_call=conv_call, net_flops_call=net_call)

    result = {}
    if traced:
        # The traced calls go through the pool as the window does; the
        # renders' least time is counted at the poses they rendered.
        traced_out = [None] * tr["profile_calls"]
        reading = trace.profile(lambda j: traced_out.__setitem__(j, call(j)), tr["profile_calls"])
        ctx["trace"] = reading
        ctx["host_syncs"] = trace.host_syncs(lambda: call(0))
        stats: dict = {}
        for j, poses in enumerate(traced_out):
            batch = s["batches"][j % len(s["batches"])]
            mesh = batch["mesh"]
            for pose in torch.cat([batch["pose0"][None], poses[:-1]]):
                render(mesh["vertices"], mesh["colors"], mesh["faces"], mesh["face_valid"],
                       pose, spec["k"].to(dev), spec["height"], spec["width"], spec["znear"], spec["zfar"], stats)
        ctx["raster_bound_s"] = work.raster_bound_s(stats)
        result["breakdown"] = {"device_ops": reading["device_ops"], "idle_gaps": reading["idle_gaps"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    failed = sum(int(not torch.isfinite(o).all()) for o in outputs)
    rng = np.random.default_rng([seed, 4])
    pool = len(calls)
    picks = []
    for j in range(min(tr["compare_calls"], n)):
        same = [i for i in range(n) if i % pool == j % pool and i not in picks]
        picks.append(int(rng.choice(same)) if same else int(rng.integers(n)))
    chosen = [(i, outputs[i]) for i in picks]
    del model, calls, outputs, s["model"], s["calls"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap, _ = reference_gap(s, chosen, dev)
    checks = [("pose_gap", gap, tr["pose_gap"])]
    result.update(correct=failed == 0 and gap <= tr["pose_gap"], attempted=n, failed=failed,
                  device=harness.device_info(cell.chips, peak) if dev.type == "cuda" else {})
    if traced:
        r = ctx["trace"]
        result["device"].update(busy_s=r["busy_s"], window_s=r["wall_s"])
    return result, ctx, checks


def reference_gap(s: dict, chosen: list, dev) -> tuple[float, float]:
    """compare.pose_gap (root mean square, widest) of the chosen calls
    [(call index, program poses (T, B, 3, 4))] against the plain reference
    on the same inputs."""
    spec = inputs.spec_to(s["spec"], dev)
    gaps = []
    for i, prog in chosen:
        b = s["batches"][i % len(s["batches"])]
        ref_poses = ref.refine(s["weights"], spec, b["mesh"], b["image_observed"], b["pose0"], prog.shape[0])
        verts = b["mesh"]["vertices"]
        step = max(1, verts.shape[1] // GAP_POINTS)
        gaps.append(compare.pose_gaps(prog, ref_poses, b["pose0"], verts[:, ::step]))
    return compare.pose_gap(gaps)
