"""The test driver (counterpart of deepim_tpu/tools/test_net.py and
experiments/deepim/deepim_test.py): load the config, restore the
checkpoint of TEST.test_epoch into a bf16 network (as the JAX package's),
refine every pair of every test class and log the 5cm5deg, ADD(-S) and
Proj2D tables.

    python -m deepim_tpu_torch.tools.test_net --cfg <experiment.yaml> [--device cuda|cpu]
        [--batch-size 16]

Without CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from deepim_tpu_torch.config import Config, load_config
from deepim_tpu_torch.data.pairdb import load_gt_pairdb
from deepim_tpu_torch.device import resolve_device, set_explicit_precision
from deepim_tpu_torch.engine.checkpoint import checkpoint_path, load_checkpoint
from deepim_tpu_torch.engine.tester import eval_flow_epe, eval_precomputed_poses, pred_eval
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.models.flownet import FlowNetDeepIM
from deepim_tpu_torch.toolkit.gen_video import gen_refine_video
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model, input_channels, rot_dim
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
    if cfg.dataset.dataset.startswith("ModelNet"):
        raise NotImplementedError("ModelNet evaluation (test_modelnet) is not ported yet (ROADMAP A10)")
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
    args = ap.parse_args(argv)
    return test_deepim(load_config(args.cfg), batch_size=args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
