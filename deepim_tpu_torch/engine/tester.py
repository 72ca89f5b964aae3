"""Batched test-time refinement and evaluation (PyTorch counterpart of
deepim_tpu/engine/tester.py).

pred_eval refines every test pair TEST.test_iter times in batches (a
Python loop over batches and over iterations, where the JAX package jits a
lax.scan), then runs the 5cm5deg, ADD(-S) and Proj2D evaluators and writes
the per-class Proj2D curves.  The refined poses are cached in
<output_dir>/results_pose.pkl, which holds numpy arrays only, so either
package reads the other's cache; a second run evaluates from it without
refining.

Sentinel initial poses (all entries -1: the detector found nothing) are
refined from a safe placeholder pose and reported at the sentinel, which
fails every threshold.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.data.loader import TestLoader
from deepim_tpu_torch.data.pairdb import load_pose_file
from deepim_tpu_torch.data.preprocess import load_depth, load_gt_observed_mask, resize_to
from deepim_tpu_torch.device import resolve_device, synchronize
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation, refine, refine_step
from deepim_tpu_torch.eval.evaluator import PoseEvaluator, _rot_trans_errors
from deepim_tpu_torch.ops.flow import flow_from_depth
from deepim_tpu_torch.ops.zoom import zoom_flow
from deepim_tpu_torch.utils import tracing
from deepim_tpu_torch.utils.logger import logger


def is_sentinel_pose(pose: np.ndarray) -> np.ndarray:
    """(B, 3, 4) -> (B,) bool: the pose is the all -1 no-detection sentinel."""
    return np.abs(pose.reshape(pose.shape[0], -1).sum(axis=1) + 12.0) < 1e-6


def _make_evaluator(cfg: Config, class_dbs: list, num_iters: int) -> PoseEvaluator:
    all_classes = list(class_dbs[0][0].classes)
    points = {db.cur_class: db.points(db.cur_class) for db, _ in class_dbs}
    diameters = {db.cur_class: db.diameter(db.cur_class) for db, _ in class_dbs}
    return PoseEvaluator(all_classes, points, diameters, cfg.dataset.intrinsic_matrix(), num_iters)


def _evaluate(evaluator: PoseEvaluator, poses_est, poses_gt) -> dict:
    return {
        "pose": evaluator.evaluate_pose(poses_est, poses_gt),
        "add": evaluator.evaluate_pose_add(poses_est, poses_gt),
        "arp_2d": evaluator.evaluate_pose_arp_2d(poses_est, poses_gt),
    }


def eval_precomputed_poses(cfg: Config, class_dbs: list, icp: bool = True) -> dict:
    """TEST.PRECOMPUTED_ICP / TEST.BEFORE_ICP: evaluate, at one iteration,
    the pose stored next to each rendered depth (-pose_icp.txt after ICP,
    -pose.txt before) instead of running the network."""
    suffix = "-pose_icp.txt" if icp else "-pose.txt"
    all_classes = list(class_dbs[0][0].classes)
    poses_est = [[[]] for _ in all_classes]
    poses_gt = [[[]] for _ in all_classes]
    for db, pairdb in class_dbs:
        cls_idx = all_classes.index(db.cur_class)
        for rec in pairdb:
            poses_est[cls_idx][0].append(load_pose_file(rec["depth_rendered"][: -len("-depth.png")] + suffix))
            poses_gt[cls_idx][0].append(rec["pose_observed"])
        rot_err, trans_err = _rot_trans_errors(np.stack(poses_est[cls_idx][0]),
                                               np.stack(poses_gt[cls_idx][0]))
        logger.info(
            "precomputed %s %s: rot %.2f +/- %.2f deg, trans %.2f +/- %.2f cm",
            "ICP" if icp else "init", db.cur_class, np.mean(rot_err), np.std(rot_err),
            np.mean(trans_err) * 100, np.std(trans_err) * 100,
        )
    return _evaluate(_make_evaluator(cfg, class_dbs, 1), poses_est, poses_gt)


def _device_batch(batch: dict, bank, dev):
    """(meshes, observation, safe initial pose on dev, sentinel mask) of
    one loader batch."""
    pose0 = batch["pose_rendered"]
    sentinel = is_sentinel_pose(pose0)
    safe_pose0 = pose0.copy()
    safe_pose0[sentinel] = np.eye(3, 4, dtype=np.float32)
    safe_pose0[sentinel, 2, 3] = 1.0
    class_index = torch.from_numpy(batch["class_index"])
    meshes = MeshBuffers.gather(bank, class_index, device=dev)
    obs = Observation(
        image_observed=torch.from_numpy(batch["image_observed"]).to(dev),
        mask_observed=torch.from_numpy(batch["mask_observed"]).to(dev),
        mask_gt_observed=None,
        depth_observed=(torch.from_numpy(batch["depth_observed"]).to(dev)
                        if "depth_observed" in batch else None),
        k=torch.from_numpy(batch["k"]).to(dev),
        class_index=class_index.to(dev),
    )
    return meshes, obs, torch.from_numpy(safe_pose0).to(dev), sentinel


def bank_on_device(bank_arrays, dev):
    """build_mesh_bank's arrays (its tuple or its texture-sampling dict)
    as tensors on dev, in the same container (gathered there per batch)."""
    if isinstance(bank_arrays, dict):
        return {k: torch.as_tensor(a).to(dev) for k, a in bank_arrays.items()}
    return tuple(torch.as_tensor(a).to(dev) for a in bank_arrays)


def eval_flow_epe(cfg: Config, model, class_dbs: list, bank_arrays, batch_size: int = 8,
                  device="cuda") -> dict:
    """Flow end-point error of the full network over TEST.test_iter
    iterations: each iteration's predicted flow, un-zoomed to the full
    frame, against the flow from that iteration's rendered depth to the
    (masked) gt-observed depth at that iteration's source pose.  Mean EPE
    over all pixels, visible pixels, and visible plus background pixels,
    per iteration ('per_iter') and for iteration 1 (the top-level keys)."""
    dev = resolve_device(device)
    ecfg = EngineConfig.from_config(cfg, train=False, bank_arrays=bank_arrays, device=dev)
    nf = float(cfg.dataset.NORMALIZE_FLOW)
    n_iter = max(1, cfg.TEST.test_iter)
    bank = bank_on_device(bank_arrays, dev)
    sums = [dict(epe_all=0.0, num_all=0.0, epe_viz=0.0, num_viz=0.0, epe_vizbg=0.0, num_vizbg=0.0)
            for _ in range(n_iter)]
    for db, pairdb in class_dbs:
        recs_iter = iter(pairdb)
        for batch, valid in TestLoader(pairdb, cfg, batch_size).batches():
            meshes, obs, pose, sentinel = _device_batch(batch, bank, dev)
            flows, depths, poses_src = [], [], []
            with torch.no_grad():
                for it in range(n_iter):
                    pose_new, aux = refine_step(model, obs, meshes, pose, ecfg, iter_index=it, device=dev)
                    flows.append(zoom_flow(aux["net"]["flow"] * nf, aux["zoom_factor"], inverse=True))
                    depths.append(aux["depth_rendered"][:, 0])
                    poses_src.append(pose)
                    pose = pose_new
            flow_pred = torch.stack(flows).cpu().numpy()    # (I, B, 2, H, W)
            depth_rend = torch.stack(depths).cpu().numpy()  # (I, B, H, W)
            poses_src = torch.stack(poses_src).cpu()         # (I, B, 3, 4)
            for j in range(valid):
                rec = next(recs_iter)
                if sentinel[j]:
                    continue
                d_obs = load_depth(rec["depth_gt_observed"], cfg.dataset.DEPTH_FACTOR)
                label = load_gt_observed_mask(rec, cfg.dataset.DEPTH_FACTOR)
                if d_obs.shape != depth_rend[0, j].shape:
                    ts, ms = cfg.SCALES[0]
                    d_obs = resize_to(d_obs, ts, ms)[0]
                    label = (resize_to(label, ts, ms)[0] >= 0.5).astype(np.float32)
                d_obs = d_obs * (label > 0)
                gt_flow, gt_valid = flow_from_depth(
                    torch.from_numpy(depth_rend[:, j]),
                    torch.from_numpy(np.tile(d_obs[None], (n_iter, 1, 1))),
                    poses_src[:, j],
                    torch.from_numpy(np.tile(rec["pose_observed"][None], (n_iter, 1, 1))),
                    torch.from_numpy(batch["k"]),
                    standard_rep=cfg.network.STANDARD_FLOW_REP,
                )
                gt_flow = gt_flow.numpy()
                gt_valid = gt_valid.numpy() > 0
                for it in range(n_iter):
                    visible = gt_valid[it]
                    bg = np.logical_and(~visible, depth_rend[it, j] == 0)
                    diff = np.sqrt(np.sum(np.square(gt_flow[it] - flow_pred[it, j]), axis=0))
                    s = sums[it]
                    s["epe_all"] += diff.sum()
                    s["num_all"] += diff.size
                    s["epe_viz"] += diff[visible].sum()
                    s["num_viz"] += visible.sum()
                    vizbg = np.logical_or(visible, bg)
                    s["epe_vizbg"] += diff[vizbg].sum()
                    s["num_vizbg"] += vizbg.sum()
    per_iter = [
        {
            "epe_all": s["epe_all"] / max(s["num_all"], 1.0),
            "epe_viz": s["epe_viz"] / max(s["num_viz"], 1.0),
            "epe_vizbg": s["epe_vizbg"] / max(s["num_vizbg"], 1.0),
        }
        for s in sums
    ]
    out = dict(per_iter[0])
    out["per_iter"] = per_iter
    for it, row in enumerate(per_iter):
        logger.info("EPE iter %d: all %.4f, ignore-unvisible %.4f, visible %.4f",
                    it + 1, row["epe_all"], row["epe_vizbg"], row["epe_viz"])
    return out


def pred_eval(cfg: Config, model, class_dbs: list, bank_arrays, output_dir: str,
              batch_size: int = 16, device="cuda") -> dict:
    """Refine every pair of every class (class_dbs: (PairDB, records) per
    class) TEST.test_iter times and evaluate.  Returns {'pose', 'add',
    'arp_2d'} tables and, when the refinement ran (no cached results),
    'run': {'pairs', 'data_s', 'net_s', 'eval_s', 'raster_dropped'}: the
    pairs refined, the loader's, the refinement's and the evaluation's
    (tables and curves) wall seconds, and the CSR face-tile pairs the
    raster budget dropped (0 for exact renders).  Each batch's data stage
    is the wait for the loader's next batch (the `loader.wait` span), its
    net stage the staging on the device, the refinement and the poses'
    copy to the host up to a synchronize (the `refine.call` span)."""
    dev = resolve_device(device)
    ecfg = EngineConfig.from_config(cfg, train=False, bank_arrays=bank_arrays, device=dev)
    num_iters = cfg.TEST.test_iter
    all_classes = list(class_dbs[0][0].classes)
    run = None

    cache_file = os.path.join(output_dir, "results_pose.pkl")
    if os.path.exists(cache_file):
        with open(cache_file, "rb") as f:
            all_poses_est, all_poses_gt = pickle.load(f)
        logger.info("loaded cached results from %s", cache_file)
    else:
        all_poses_est = [[[] for _ in range(num_iters)] for _ in all_classes]
        all_poses_gt = [[[] for _ in range(num_iters)] for _ in all_classes]
        bank = bank_on_device(bank_arrays, dev)
        t_data = t_net = 0.0
        n_pairs = n_dropped = 0
        synchronize(dev)
        for db, pairdb in class_dbs:
            cls_idx = all_classes.index(db.cur_class)
            batches = TestLoader(pairdb, cfg, batch_size).batches()
            while True:
                t0 = time.perf_counter()
                with tracing.span("loader.wait"):
                    item = next(batches, None)
                t_data += time.perf_counter() - t0
                if item is None:
                    break
                batch, valid = item
                t0 = time.perf_counter()
                with tracing.span("refine.call", dev):
                    meshes, obs, safe_pose0, sentinel = _device_batch(batch, bank, dev)
                    _, poses, stats = refine(model, obs, meshes, safe_pose0, ecfg, num_iters,
                                             with_stats=True, device=dev)
                    poses = poses.cpu().numpy()  # (iters, B, 3, 4)
                    nd = int(stats["raster_dropped"])
                    synchronize(dev)
                t_net += time.perf_counter() - t0
                n_dropped += nd
                if nd:
                    logger.warning("rasterizer dropped %d face-tile pairs for class %s - raise "
                                   "RasterConfig.bin_pairs", nd, db.cur_class)
                pose0 = batch["pose_rendered"]
                for it in range(num_iters):
                    for j in range(valid):
                        all_poses_est[cls_idx][it].append(pose0[j] if sentinel[j] else poses[it, j])
                        all_poses_gt[cls_idx][it].append(batch["pose_observed"][j])
                n_pairs += valid
        logger.info("pred_eval timing: data %.1fs net %.1fs", t_data, t_net)
        run = {"pairs": n_pairs, "data_s": t_data, "net_s": t_net, "raster_dropped": n_dropped}
        os.makedirs(output_dir, exist_ok=True)
        with open(cache_file, "wb") as f:
            pickle.dump([all_poses_est, all_poses_gt], f, protocol=4)

    t0 = time.perf_counter()
    results = _evaluate(_make_evaluator(cfg, class_dbs, num_iters), all_poses_est, all_poses_gt)
    dump_proj2d_curves(results["arp_2d"], output_dir, num_iters)
    if run is not None:
        run["eval_s"] = time.perf_counter() - t0
        results["run"] = run
    return results


def dump_proj2d_curves(arp_2d: dict, output_dir: str, num_iters: int) -> None:
    """Write proj2d_curves_iter<n>.txt: each class's Proj2D accuracy (%)
    at every whole pixel threshold from 0 to 49."""
    classes = [c for c in arp_2d if arp_2d[c]]
    if not classes:
        return
    os.makedirs(output_dir, exist_ok=True)
    for it in range(num_iters):
        rows = {c: arp_2d[c][it] for c in classes if it in arp_2d[c]}
        if not rows:
            continue
        path = os.path.join(output_dir, f"proj2d_curves_iter{it + 1}.txt")
        thr = np.asarray(next(iter(rows.values()))["curve_thresholds"])
        with open(path, "w") as f:
            f.write("# Proj2D accuracy (%) vs pixel threshold, iter "
                    f"{it + 1}\n# px " + " ".join(classes) + "\n")
            for ti in range(0, len(thr), 10):  # 1 px steps of the 0.1 px grid
                vals = " ".join(f"{rows[c]['curve'][ti]:.2f}" for c in classes)
                f.write(f"{thr[ti]:.1f} {vals}\n")
        logger.info("wrote %s", path)
