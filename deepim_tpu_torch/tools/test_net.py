"""The test driver (counterpart of deepim_tpu/tools/test_net.py and
experiments/deepim/deepim_test.py): load the config, restore the
checkpoint of TEST.test_epoch into a bf16 network (as the JAX package's),
refine every pair of every test class and log the 5cm5deg, ADD(-S) and
Proj2D tables.  A dataset.dataset named ModelNet* is the unseen-object
evaluation instead (test_modelnet: dataset.model_file and pose_file,
renders lit by a point light).

    python -m deepim_tpu_torch.tools.test_net --cfg <experiment.yaml> [--device cuda|cpu]
        [--batch-size 16] [--trace-out trace.json]

Without CUDA it raises unless given --device cpu.  --trace-out turns the
port's spans on (utils/tracing.py) and writes the last calls as a
Chrome-trace JSON at the end.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from deepim_tpu_torch.config import Config, load_config
from deepim_tpu_torch.data.modelnet import ModelNetDB
from deepim_tpu_torch.data.pairdb import load_gt_pairdb
from deepim_tpu_torch.device import resolve_device, set_explicit_precision, synchronize
from deepim_tpu_torch.engine.checkpoint import checkpoint_path, load_checkpoint
from deepim_tpu_torch.engine.refine import (
    EngineConfig,
    LightParams,
    MeshBuffers,
    Observation,
    refine,
    render_at_pose,
)
from deepim_tpu_torch.engine.tester import bank_on_device, eval_flow_epe, eval_precomputed_poses, pred_eval
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.models.flownet import FlowNetDeepIM
from deepim_tpu_torch.ops.masks import box_fill
from deepim_tpu_torch.toolkit.gen_video import gen_refine_video
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model, input_channels, rot_dim
from deepim_tpu_torch.utils import tracing
from deepim_tpu_torch.utils.logger import create_logger, logger


# The eval network's dtype: bf16, as the JAX test_deepim builds it (tests
# that hold the driver to an fp32 JAX run patch this).
EVAL_DTYPE = torch.bfloat16


def _eval_model(cfg: Config, init_from: FlowNetDeepIM | None = None) -> FlowNetDeepIM:
    """The eval model, in EVAL_DTYPE.  FAST_TEST drops the flow
    decoder and the mask head when the test protocol does not use them.
    Built on the meta device: its weights come from a checkpoint or, given
    `init_from`, from that model (any dtype: the weights are float32)."""
    keep_flow = cfg.network.PRED_FLOW and not cfg.TEST.FAST_TEST
    keep_mask = cfg.network.PRED_MASK and (
        cfg.TEST.UPDATE_MASK not in ("init", "box_rendered") or not cfg.TEST.FAST_TEST
    )
    model = FlowNetDeepIM(in_channels=input_channels(cfg), input_hw=(cfg.height, cfg.width),
                          pred_flow=keep_flow, pred_mask=keep_mask,
                          num_regressors=cfg.network.REGRESSOR_NUM, rot_dim=rot_dim(cfg),
                          dtype=EVAL_DTYPE, device="meta").eval()
    if init_from is not None:
        model.load_state_dict(init_from.state_dict(), strict=False, assign=True)
    return model


def test_modelnet(cfg: Config, model: FlowNetDeepIM, batch_size: int = 16, device="cuda") -> dict:
    """Unseen-object evaluation (the reference's ModelNet branch,
    tester.py:114): the novel meshes and gt poses of dataset.model_file
    and pose_file (data/modelnet.py), each observed image rendered at the
    gt pose under the record's point light, its mask boxed, then refined
    TEST.test_iter times with renders lit the same way.  The last batch is
    padded with the last record.  Returns 'init' and 'iters' (one per
    iteration), each {'rot_err' (N,) degrees, 'trans_err' (N,) metres},
    and 'run': the pairs, 'data_s' (meshes, bank, records), 'net_s' (the
    renders and refinement, poses on the host), 'eval_s' and
    'raster_dropped' (CSR face-tile pairs dropped by any render).  Each
    stage ends at a synchronize; each batch's renders and refinement are
    one `refine.call` span."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    db = ModelNetDB(cfg.dataset.model_file, cfg.dataset.pose_file)
    bank = db.mesh_bank()
    bank_arrays = (bank.vertices, bank.colors, bank.faces, bank.face_valid, bank.normals)
    records = db.sample_records()
    ecfg = EngineConfig.from_config(cfg, train=False, bank_arrays=bank_arrays, device=dev)
    k = torch.from_numpy(cfg.dataset.intrinsic_matrix()).to(dev)
    bank_d = bank_on_device(bank_arrays, dev)
    synchronize(dev)
    data_s = time.perf_counter() - t0

    def stacked(recs, key):
        return torch.from_numpy(np.stack([r[key] for r in recs])).to(dev)

    t0 = time.perf_counter()
    n = len(records)
    all_poses, drops = [], []
    for start in range(0, n, batch_size):
        with tracing.span("refine.call", dev):
            recs = [records[min(start + j, n - 1)] for j in range(batch_size)]
            meshes = MeshBuffers.gather(bank_d, np.asarray([r["model_index"] for r in recs]), device=dev)
            light = LightParams(stacked(recs, "light_position"), stacked(recs, "light_intensity"),
                                stacked(recs, "brightness_ratio"))
            img, _, mask, dropped = render_at_pose(meshes, stacked(recs, "pose_observed"), k, ecfg, light,
                                                   with_stats=True, device=dev)
            obs = Observation(img, box_fill(mask), None, None, k, light=light)
            _, poses, stats = refine(model, obs, meshes, stacked(recs, "pose_rendered"), ecfg,
                                     with_stats=True, device=dev)
            drops += [dropped, stats["raster_dropped"]]
            all_poses.append(poses[:, : min(batch_size, n - start)])
    poses_iter = torch.cat(all_poses, dim=1).cpu().numpy()  # (iters, N, 3, 4)
    n_dropped = int(torch.stack(drops).sum())
    synchronize(dev)
    net_s = time.perf_counter() - t0
    if n_dropped:
        logger.warning("rasterizer dropped %d face-tile pairs - raise RasterConfig.bin_pairs", n_dropped)

    t0 = time.perf_counter()
    pose_gt = np.stack([r["pose_observed"] for r in records])
    pose0 = np.stack([r["pose_rendered"] for r in records])
    r0, t0_err = _modelnet_errors(pose0, pose_gt)
    logger.info("ModelNet init: rot<5deg %.2f, trans<5cm %.2f (mean %.2fdeg / %.1fmm)",
                np.mean(r0 < 5) * 100, np.mean(t0_err < 0.05) * 100, r0.mean(), t0_err.mean() * 1000)
    results = {"init": {"rot_err": r0, "trans_err": t0_err}, "iters": []}
    for it in range(poses_iter.shape[0]):
        r, t = _modelnet_errors(poses_iter[it], pose_gt)
        logger.info("ModelNet iter %d: 5cm5deg %.2f (rot<5deg %.2f, trans<5cm %.2f; mean %.2fdeg / %.1fmm)",
                    it + 1, np.mean((r < 5) & (t < 0.05)) * 100, np.mean(r < 5) * 100, np.mean(t < 0.05) * 100,
                    r.mean(), t.mean() * 1000)
        results["iters"].append({"rot_err": r, "trans_err": t})
    results["run"] = {"pairs": n, "data_s": data_s, "net_s": net_s, "eval_s": time.perf_counter() - t0,
                      "raster_dropped": n_dropped}
    return results


test_modelnet.__test__ = False  # not a pytest test


def _modelnet_errors(poses_est: np.ndarray, pose_gt: np.ndarray):
    """(N, 3, 4) x2 -> rotation error (degrees, from the trace) and
    translation error (metres), each (N,)."""
    terr = np.linalg.norm(poses_est[:, :, 3] - pose_gt[:, :, 3], axis=-1)
    tr = np.einsum("bij,bij->b", poses_est[:, :, :3], pose_gt[:, :, :3])
    rerr = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    return rerr, terr


def test_deepim(cfg: Config, output_dir: str | None = None, batch_size: int = 16,
                device="cuda", model: FlowNetDeepIM | None = None) -> dict:
    """Evaluate cfg's model on cfg.dataset.test_image_set.  The weights are
    those of `model` when given (no checkpoint is read); else they come
    from <output_dir>/<model_prefix>_ckpt/<test_epoch>, and when that file
    does not exist the fixed-seed initial weights are used, with a warning.
    A checkpoint that exists but does not fit the model raises.  When the
    refinement ran, results['run'] (see pred_eval) also holds the host
    seconds of the stages before it: 'model_s' (network and checkpoint),
    'bank_s' (mesh bank) and 'pairdb_s' (pair lists), and 'pred_eval_s'.
    TEST.VIS_VIDEO writes each class's refinement video to
    <output_dir>/video_<class>.avi (toolkit/gen_video.py, its first 8
    pairs) and returns what gen_refine_video returned under
    results['videos'][class].

    The eval network computes in EVAL_DTYPE (bf16, as the JAX test_deepim's)
    whatever `model`'s dtype, and on CUDA the image zoom is bf16 too.  Precision on the card is set explicitly first
    (set_explicit_precision: no TF32, bf16 matmuls reduced in float32)."""
    dev = resolve_device(device)
    set_explicit_precision()
    if output_dir is None:
        output_dir = create_logger(cfg.output_path, cfg.TRAIN.model_prefix, cfg.dataset.test_image_set)
    stages = {}
    t0 = time.perf_counter()
    prefix = os.path.join(output_dir, cfg.TRAIN.model_prefix)
    path = checkpoint_path(prefix, cfg.TEST.test_epoch)
    if model is not None:
        eval_model = _eval_model(cfg, init_from=model)
    elif os.path.exists(path):
        eval_model = _eval_model(cfg)
        # The full model's entries that the eval model drops may be in the
        # checkpoint; every entry the eval model has must be.
        dropped = frozenset(build_model(cfg, device="meta").state_dict()) - frozenset(eval_model.state_dict())
        load_checkpoint(prefix, cfg.TEST.test_epoch, TrainState(eval_model, None), allow_unexpected=dropped)
        logger.info("loaded params for test epoch %d", cfg.TEST.test_epoch)
    else:
        logger.warning("no checkpoint restored from %s epoch %d (%s does not exist); using init params",
                       prefix, cfg.TEST.test_epoch, path)
        eval_model = _eval_model(cfg, init_from=build_model(cfg, device="cpu"))
    eval_model = eval_model.to(dev)
    stages["model_s"] = time.perf_counter() - t0
    if cfg.dataset.dataset.startswith("ModelNet"):
        results = test_modelnet(cfg, eval_model, batch_size, device=dev)
        results["run"].update(stages)
        return results

    t0 = time.perf_counter()
    bank_arrays = build_mesh_bank(cfg)
    stages["bank_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataset_name = cfg.dataset.dataset.split("+")[0]
    iset = cfg.dataset.test_image_set
    class_dbs = [
        load_gt_pairdb(cfg, dataset_name, iset + cls if iset.endswith("_") else iset, cls,
                       cfg.dataset.root_path, cfg.dataset.dataset_path, pair_flip=cfg.TEST.FLIP_PAIR)
        for cls in cfg.dataset.class_name
    ]
    stages["pairdb_s"] = time.perf_counter() - t0
    if cfg.TEST.PRECOMPUTED_ICP:
        return eval_precomputed_poses(cfg, class_dbs, icp=True)
    if cfg.TEST.BEFORE_ICP:
        return eval_precomputed_poses(cfg, class_dbs, icp=False)
    t0 = time.perf_counter()
    results = pred_eval(cfg, eval_model, class_dbs, bank_arrays, output_dir, batch_size, device=dev)
    stages["pred_eval_s"] = time.perf_counter() - t0
    if "run" in results:
        results["run"].update(stages)
    if cfg.network.PRED_FLOW and not cfg.TEST.FAST_TEST:  # then eval_model is the full model
        results["flow_epe"] = eval_flow_epe(cfg, eval_model, class_dbs, bank_arrays, batch_size, device=dev)
    if cfg.TEST.VIS_VIDEO:
        # Each class's refinement-iteration video, also when pred_eval was
        # served from its cache.
        results["videos"] = {
            db.cur_class: gen_refine_video(cfg, eval_model, pairdb, bank_arrays,
                                           os.path.join(output_dir, f"video_{db.cur_class}.avi"), device=dev)
            for db, pairdb in class_dbs
        }
    return results


test_deepim.__test__ = False  # not a pytest test


def main(argv: list[str] | None = None) -> dict:
    """The CLI: test_deepim on --cfg, which sets the card's precision
    (set_explicit_precision) before it builds the bf16 eval network."""
    ap = argparse.ArgumentParser(description="Evaluate DeepIM (PyTorch port) on a test set")
    ap.add_argument("--cfg", required=True, help="experiment YAML file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--trace-out", help="write the spans of the last calls here (Chrome-trace JSON)")
    args = ap.parse_args(argv)
    if args.trace_out:
        tracing.enable()
    try:
        return test_deepim(load_config(args.cfg), batch_size=args.batch_size, device=args.device)
    finally:
        if args.trace_out:
            tracing.disable()
            tracing.write(args.trace_out)


if __name__ == "__main__":
    main()
