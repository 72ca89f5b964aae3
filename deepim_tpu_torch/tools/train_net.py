"""The training driver (counterpart of deepim_tpu/tools/train_net.py): load
the pair lists of every dataset x image set x class, build the
class-indexed mesh bank and the network, and run the epoch loop through
the train step with per-epoch checkpoints and throughput logging.  On one
device, or data-parallel over the ranks of a torch.distributed launch, one
card each:

    python -m deepim_tpu_torch.tools.train_net --cfg <experiment.yaml> [--device cuda|cpu]
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepim_tpu_torch.tools.train_net --cfg <experiment.yaml>

Without CUDA it raises unless given --device cpu (gloo between ranks).
--trace-out PATH turns the port's spans on (utils/tracing.py) and writes
the last steps as a Chrome-trace JSON at the end (rank r of several ranks
writes PATH with `.rank<r>` before its suffix).
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from deepim_tpu_torch.config import Config, load_config
from deepim_tpu_torch.data.loader import TrainLoader
from deepim_tpu_torch.data.pairdb import load_gt_pairdb, merge_pairdb
from deepim_tpu_torch.device import resolve_device, set_explicit_precision, synchronize
from deepim_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from deepim_tpu_torch.engine.lr_schedule import lr_steps_from_config, warmup_multifactor_schedule
from deepim_tpu_torch.engine.refine import EngineConfig
from deepim_tpu_torch.engine.tester import bank_on_device
from deepim_tpu_torch.engine.train import TrainState, make_optimizer, make_train_step
from deepim_tpu_torch.models.flownet import FlowNetDeepIM
from deepim_tpu_torch.models.import_mxnet import state_dict_from_mxnet
from deepim_tpu_torch.parallel import (
    find_unused_parameters,
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
    train_step_dp,
)
from deepim_tpu_torch.render.mesh import MeshBank, load_textured_mesh
from deepim_tpu_torch.tools.convert_mxnet_checkpoint import load_npz_state_dict
from deepim_tpu_torch.utils import tracing
from deepim_tpu_torch.utils.logger import create_logger, logger, run_directory
from deepim_tpu_torch.utils.mxnet_io import load_mxnet_params
from deepim_tpu_torch.utils.speedometer import Speedometer
from deepim_tpu_torch.utils.tb import TBLogger
from deepim_tpu_torch.utils.visualize import visualize_masks, visualize_pair_grid


def load_pairdbs(cfg: Config):
    """Per (dataset x image_set x class) pair databases and their records
    merged (deepim/train.py:89-102)."""
    datasets = cfg.dataset.dataset.split("+")
    image_sets = cfg.dataset.image_set.split("+")
    dbs, merged = [], []
    for ds_name, iset in zip(datasets, image_sets):
        for cls in cfg.dataset.class_name:
            db, pairdb = load_gt_pairdb(cfg, ds_name, iset + cls if iset.endswith("_") else iset, cls,
                                        cfg.dataset.root_path, cfg.dataset.dataset_path)
            dbs.append(db)
            merged.append(pairdb)
    return dbs, merge_pairdb(merged)


def build_mesh_bank(cfg: Config):
    """Load every class's model from dataset.model_dir into one bank.
    Returns the (vertices, colors, faces, face_valid) numpy arrays, or,
    with dataset.TEXTURE_SAMPLING, MeshBank.arrays()'s dict, which adds
    each class's uv and zero-padded texture (load_textured_mesh with
    keep_texture); MeshBuffers.gather takes either."""
    keep_tex = cfg.dataset.TEXTURE_SAMPLING
    meshes = [load_textured_mesh(os.path.join(cfg.dataset.model_dir, cls), keep_texture=keep_tex)
              for cls in cfg.dataset.class_name]
    bank = MeshBank.from_meshes(meshes, keep_textures=keep_tex)
    if keep_tex:
        return bank.arrays()
    return bank.vertices, bank.colors, bank.faces, bank.face_valid


def build_model(cfg: Config, dtype=torch.bfloat16, device="cuda") -> FlowNetDeepIM:
    """The matching network for cfg at cfg's resolution with its heads
    (REGRESSOR_NUM groups, a quaternion or EULER rotation head), in eval
    mode, its float32 weights drawn from a fixed seed (0, as the JAX package
    initialises from PRNGKey(0)).  It computes in `dtype`: bf16 by default,
    as the JAX package's build_model; pass torch.float32 for an fp32
    network."""
    return FlowNetDeepIM(
        in_channels=input_channels(cfg), input_hw=(cfg.height, cfg.width),
        pred_flow=cfg.network.PRED_FLOW, pred_mask=cfg.network.PRED_MASK,
        num_regressors=cfg.network.REGRESSOR_NUM, rot_dim=rot_dim(cfg), dtype=dtype,
        generator=torch.Generator().manual_seed(0), device=resolve_device(device),
    ).eval()


def rot_dim(cfg: Config) -> int:
    return 3 if cfg.network.ROT_TYPE == "EULER" else 4


def input_channels(cfg: Config) -> int:
    return 6 + (2 if cfg.network.INPUT_DEPTH else 0) + (2 if cfg.network.INPUT_MASK else 0)


def init_pretrained(cfg: Config, model: FlowNetDeepIM) -> None:
    """Load network.pretrained into `model` (deepim/train.py:165-195: the
    reference fine-tunes a pretrained FlowNet), as the JAX package's
    init_pretrained: a path without a .npz or .params suffix is the
    reference's <prefix>-%04d.params of network.pretrained_epoch (also at
    epoch 0 when the bare path is no file); a .npz is the JAX converter's
    flax tree or this port's converter output, holding every layer of the
    model; a .params file is imported on the fly (state_dict_from_mxnet at
    cfg's resolution), where with network.init_from_flownet the layers a
    vanilla FlowNet lacks (the fc/rot/trans and mask heads) keep the
    model's seeded initialisation and without it every layer must be
    present.  The weights load into the model's parameters in place, on
    its device."""
    path = cfg.network.pretrained
    if not path.endswith((".npz", ".params")) and (cfg.network.pretrained_epoch or not os.path.isfile(path)):
        path = f"{path}-{cfg.network.pretrained_epoch:04d}.params"
    if path.endswith(".npz"):
        loaded = load_npz_state_dict(path)
        own = model.state_dict()
        for key, value in own.items():
            if key not in loaded:
                raise KeyError(f"pretrained npz {path} is missing {key}")
            if loaded[key].shape != value.shape:
                raise ValueError(f"{key}: npz shape {tuple(loaded[key].shape)} != model {tuple(value.shape)}")
        state = {k: loaded[k] for k in own}
    else:
        state = state_dict_from_mxnet(load_mxnet_params(path), model, input_hw=(cfg.height, cfg.width),
                                      strict=not cfg.network.init_from_flownet)
    model.load_state_dict(state)
    logger.info("initialized from pretrained weights %s", path)


def train_net(cfg: Config, output_dir: str | None = None, device="cuda",
              init_state_dict: dict | None = None) -> TrainState:
    """Train cfg's network from TRAIN.begin_epoch to TRAIN.end_epoch and
    return the final state (its model on `device`).  The weights start from
    `init_state_dict` when given, else from network.pretrained
    (init_pretrained, unless network.skip_initialize) loaded over
    build_model's seeded draw, before DDP wraps the model; with
    TRAIN.RESUME and begin_epoch > 0 the state of that epoch's checkpoint
    replaces them.  Checkpoints go to <output_dir>/<model_prefix>_ckpt/.

    Losses reach the host only every 20 batches, at an epoch's last batch,
    or on every batch when TensorBoard logs, as one copy of the stacked
    metrics.  After each epoch the returned state's `epochs` gains one dict:
    the epoch, its samples, seconds (the loop, its time blocked on the
    loader, its time in train steps, the checkpoint), the decode cache's
    hits and misses, non-finite loss values, dropped face-tile pairs, and
    `metrics`, every metric's value at each step and inner iteration
    ({name: (steps, TRAIN_ITER_SIZE) array}, one copy after the loop).

    The network is build_model's bf16 one (a caller's `init_state_dict`
    holds float32 weights either way).  Precision on the card is set
    explicitly first (set_explicit_precision: no TF32, bf16 matmuls
    reduced in float32).

    In a process group (parallel.initialize_distributed) it trains
    data-parallel, as the JAX train_net over its device mesh: the global
    batch is BATCH_PAIRS x ranks, each rank assembling its rows
    (TrainLoader) and stepping through train_step_dp (DDP, with
    find_unused_parameters(cfg)); the LR schedule counts global batches.
    Rank 0 alone creates the run directory and its log file, logs the
    Speedometer and TensorBoard, dumps TRAIN.VISUALIZE grids and saves
    checkpoints, every rank waiting after each save; the other ranks log
    at WARNING.  Every rank resumes from the checkpoint, and every rank's
    `epochs` hold the global samples and the metrics of every rank."""
    dev = resolve_device(device)
    set_explicit_precision()
    mesh = make_mesh(device=dev)
    lead = mesh.rank == 0
    if not lead:
        logger.setLevel(logging.WARNING)
    if output_dir is None:
        output_dir = (create_logger if lead else run_directory)(cfg.output_path, cfg.TRAIN.model_prefix,
                                                                 cfg.dataset.image_set)
    dbs, pairdb = load_pairdbs(cfg)
    logger.info("num pairs: %d", len(pairdb))
    points_by_class = {cls: dbs[0].points(cls) for cls in cfg.dataset.class_name}
    bank_arrays = build_mesh_bank(cfg)

    batch_size = cfg.TRAIN.BATCH_PAIRS * mesh.size
    loader = TrainLoader(pairdb, cfg, points_by_class, batch_size, process_index=mesh.rank,
                         process_count=mesh.size)
    epoch_size = loader.epoch_size

    model = build_model(cfg, device=dev).train()
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
        logger.info("initialized from caller-provided weights")
    elif cfg.network.pretrained and not cfg.network.skip_initialize:
        init_pretrained(cfg, model)
    begin_epoch = cfg.TRAIN.begin_epoch
    schedule = warmup_multifactor_schedule(
        cfg.TRAIN.lr,
        lr_steps_from_config(cfg.TRAIN.lr_step, epoch_size * cfg.network.TRAIN_ITER_SIZE, begin_epoch),
        warmup=cfg.TRAIN.warmup, warmup_lr=cfg.TRAIN.warmup_lr, warmup_step=cfg.TRAIN.warmup_step,
    )
    state = TrainState(model, make_optimizer(model.parameters(), cfg.TRAIN, schedule))
    prefix = os.path.join(output_dir, cfg.TRAIN.model_prefix)
    if cfg.TRAIN.RESUME and begin_epoch > 0:
        state = load_checkpoint(prefix, begin_epoch, state)
        logger.info("resumed from epoch %d (step %d)", begin_epoch, state.step)

    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=bank_arrays, device=dev)
    step_fn = train_step_dp(make_train_step(ecfg, cfg.train_iter, cfg.TRAIN.FLOW_WEIGHT_TYPE, device=dev),
                            mesh, state, find_unused_parameters(cfg))
    bank_d = bank_on_device(bank_arrays, dev)
    speedo = Speedometer(batch_size, frequent=20)
    tb = TBLogger(os.path.join(output_dir, "tb"), enabled=cfg.TRAIN.TENSORBOARD_LOG and lead)

    for epoch in range(begin_epoch, cfg.TRAIN.end_epoch):
        per_step = []
        wait_s = step_s = 0.0
        cache = loader.cache
        hits0, misses0 = (cache.hits, cache.misses) if cache else (0, 0)
        t_epoch = tic = time.perf_counter()
        for nbatch, batch in enumerate(loader.epoch(epoch)):
            t0 = time.perf_counter()
            wait_s += t0 - tic
            state, metrics, _ = step_fn(state, batch, bank_d)
            step_s += time.perf_counter() - t0
            names = sorted(metrics)
            stacked = torch.stack([metrics[k].float() for k in names])  # (metrics, TRAIN_ITER_SIZE)
            per_step.append(stacked)
            host_metrics = None
            if lead and (nbatch % speedo.frequent == 0 or nbatch == epoch_size - 1 or tb.enabled):
                values = stacked.cpu()
                host_metrics = {}
                for k, vals in zip(names, values):
                    for it in range(vals.shape[0]):
                        host_metrics[f"{k}/iter{it}"] = float(vals[it])
                    host_metrics[k] = float(vals[-1])
            if host_metrics is not None and host_metrics.get("raster_dropped", 0) > 0:
                logger.warning(
                    "rasterizer dropped %d face-tile pairs at epoch %d batch %d - renders have holes; "
                    "raise RasterConfig.bin_pairs",
                    int(sum(v for k, v in host_metrics.items() if k.startswith("raster_dropped/"))),
                    epoch, nbatch,
                )
            if lead:
                speedo(epoch, nbatch, host_metrics)
            if tb.enabled:
                host_metrics["lr"] = schedule(state.step)
                tb.scalars(host_metrics, state.step)
            if lead and cfg.TRAIN.VISUALIZE and nbatch % 100 == 0:
                _dump_batch_vis(batch, os.path.join(output_dir, "vis"), f"e{epoch}_b{nbatch}")
            tic = time.perf_counter()
        synchronize(dev)
        loop_s = time.perf_counter() - t_epoch
        if tb.enabled:
            tb.weight_norms(state.model, epoch + 1)
            tb.flush()
        ckpt_s = 0.0
        if (epoch + 1) % cfg.TRAIN.CHECKPOINT_INTERVAL == 0 or epoch + 1 == cfg.TRAIN.end_epoch:
            t0 = time.perf_counter()
            if lead:
                save_checkpoint(prefix, epoch + 1, state)
                logger.info("saved checkpoint epoch %d", epoch + 1)
            mesh.barrier()
            ckpt_s = time.perf_counter() - t0
        values = torch.stack(per_step).cpu().numpy()  # (steps, metrics, TRAIN_ITER_SIZE)
        stats = {
            "epoch": epoch + 1, "samples": epoch_size * batch_size, "loop_s": loop_s, "wait_s": wait_s,
            "step_s": step_s, "checkpoint_s": ckpt_s,
            "cache_hits": cache.hits - hits0 if cache else 0,
            "cache_misses": cache.misses - misses0 if cache else 0,
            "nonfinite_losses": int((~np.isfinite(values)).sum()),
            "raster_dropped": int(values[:, names.index("raster_dropped")].sum()),
            "metrics": {k: values[:, i] for i, k in enumerate(names)},
        }
        state.epochs.append(stats)
        logger.info(
            "Epoch[%d] done: %d samples in %.3f s (%.2f samples/s), %.3f s waiting for the loader, %.3f s in "
            "train steps; checkpoint %.3f s; decode cache %d hits, %d misses; %d non-finite loss values, "
            "%d dropped face-tile pairs", epoch, stats["samples"], loop_s, stats["samples"] / loop_s, wait_s,
            step_s, ckpt_s, stats["cache_hits"], stats["cache_misses"], stats["nonfinite_losses"],
            stats["raster_dropped"],
        )
        if stats["nonfinite_losses"] or stats["raster_dropped"]:
            logger.warning("epoch %d: %d non-finite loss values, %d dropped face-tile pairs", epoch,
                           stats["nonfinite_losses"], stats["raster_dropped"])
    tb.close()
    return state


def _dump_batch_vis(batch, vis_dir: str, tag: str) -> None:
    """TRAIN.VISUALIZE: the batch's observed images and masks as PNG
    grids (headless counterpart of the reference's SimpleVisualize and
    MaskVisualize metrics, deepim/core/metric.py:140-486)."""
    obs = batch.image_observed.numpy()
    visualize_pair_grid(os.path.join(vis_dir, f"{tag}_pairs.png"), obs, obs * 0)
    visualize_masks(os.path.join(vis_dir, f"{tag}_masks.png"), batch.mask_observed.numpy(),
                    batch.mask_gt_observed.numpy())


def main(argv: list[str] | None = None) -> TrainState:
    """The CLI: train_net on --cfg, which sets the card's precision
    (set_explicit_precision) before it builds the bf16 network.  Under
    torch.distributed.run it joins the process group first
    (initialize_distributed: NCCL on the cards, gloo with --device cpu)
    and leaves it at the end."""
    ap = argparse.ArgumentParser(description="Train DeepIM (PyTorch port)")
    ap.add_argument("--cfg", required=True, help="experiment YAML file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace-out", help="write the spans of the last steps here (Chrome-trace JSON)")
    args = ap.parse_args(argv)
    owns_group = initialize_distributed(device=args.device)
    if args.trace_out:
        tracing.enable()
    try:
        return train_net(load_config(args.cfg), device=args.device)
    finally:
        if args.trace_out:
            tracing.disable()
            path = args.trace_out
            if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}.rank{torch.distributed.get_rank()}{ext}"
            tracing.write(path)
        if owns_group:
            shutdown_distributed()


if __name__ == "__main__":
    main()
