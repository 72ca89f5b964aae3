#!/usr/bin/env python3
"""On-card smoke run of deepim_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py               # every phase: one CUDA device, nvcc on PATH or in $CUDA_HOME
    python3 chip_smoke.py --phases 12   # phase 1 (device, build) and phase 12 alone, e.g. on four cards

Phases (each raises on failure; the script then exits non-zero):
  1. device and build: the card's name and power limit, torch's CUDA
     version and the precision flags (set_explicit_precision: TF32 off,
     bf16 matmuls reduced in fp32, as every entry point sets them), and the
     nvcc build of csrc/raster.cu;
  2. each raster kernel against its plain PyTorch twin on the card, on the
     kernel inputs of one render of its path's scene (480x640; 20,480-face
     icospheres, batch 16 for csr_raster and batch 4 for csr_planes_raster;
     for tile_raster the light shape, the batch-2 320-face scene, and the
     heavy one, batch 16 of 1,280-face icospheres with lists of up to 512
     faces, none of which may reach that cap): hit masks and face ids
     exact, q to 1e-6, rgb to 5e-3; the kernel's device time per launch (20
     launches replayed as one CUDA graph, so the wrapper's host share stays
     out), the time of a single call between CUDA events (host share
     included, which is larger for kernels this short) and the twin's;
     csr_planes_raster equal to csr_raster on the same render; and every
     kernel bit-equal to its twin on the hand-built stress work lists
     (render/stress.py.  CSR: a 1,328-face tile, exact 1/z ties, degenerate
     and invalid faces, empty items; pack 1 and 4, tile_w 8, 16, 128 and 2.
     Dense: lists of 0 to 512 faces (one more and one fewer than a pass of
     the kernel among them) in ascending, descending and shuffled order with
     ties the first in the list must win; six tile shapes);
  3. the main path on the CSR kernel: refine(), 4 iterations, batch 16,
     20,480-face meshes, FAST_TEST network (encoder + SE(3) head), seeded
     random weights with a small nonzero translation head, one warm-up and
     three chained calls, in each precision in turns (fp32 with TF32 off;
     TF32 as torch's defaults give it, cuDNN TF32 and cuBLAS fp32; bf16
     network and image zoom, the drivers' default on the card: fp32, tf32,
     bf16, bf16, tf32, fp32);
  4. the main path on the dense kernel: the 320-face scene, batch 2, the
     full network (flow and mask heads) in fp32, one warm-up and five
     chained calls;
  5. the training path on csr_planes_raster (planes64): make_train_step
     at 480x640, batch 4, 4 inner iterations, the full network with seeded
     random weights, the lm6d_ape_iter4_8epoch recipe's losses and SGD
     (plus global-norm clipping, see RECIPE_TCFG); one warm-up and three
     timed steps in each precision, in phase 3's turns;
  6. where one call's (or step's) device time goes on each path
     (torch.profiler: time by kernel family, the device's idle share, the
     top kernels; the eval call and the training step in each precision,
     the convolutions beside their FLOP bound), and one batch-16 CSR render
     timed with slots8 and with planes64;
  7. small-input reference checks: the card's renders, refinement and
     training step equal the CPU path (the one the tests hold to the JAX
     package), and so do the eval driver (pred_eval) and one epoch of the
     training driver (train_net, same initial weights) on 64x64 devkits:
     each in fp32 (TF32 off) and again in bf16 (network and image zoom bf16
     on both sides), and a 2-iteration refine with each engine option
     (box_observed, two per-class EULER head groups, input_depth,
     input_mask=False) in fp32;
  8. the eval driver through its front door: tools/synth_data.py writes a
     480x640 LINEMOD-layout devkit (LINEMOD intrinsics; classes "cube", a
     0.08 m cube, and "sphere", a 20,480-face icosphere of radius 0.05 m;
     256 test pairs each, one rendered initial pose per pair, PNG rows Sub
     filtered as cv2 writes them) into
     deepim_tpu_torch/_build/phase8/; the config is
     experiments/deepim/cfgs/lm6d_ape_iter4_8epoch.yaml read by the port's
     YAML reader, its dataset paths, classes and test set overridden; a
     seeded checkpoint is saved with save_checkpoint; test_deepim runs at
     batch 16 once to warm up and once timed into a fresh directory
     (bf16 eval network and image zoom, the driver's default; csr_raster,
     and nothing else, launched exactly the planned number of
     times, every table finite, no dropped pairs), then once more on the
     cached results_pose.pkl (no launch); it prints frames/s over
     pred_eval's loop (32 batches), the loop's data/net split, the call's
     other stages as test_deepim reports them, and the PNG decode time per
     image for each row filter;
  9. the training driver through its front door: a second devkit, the
     same classes and intrinsics with 32 training and 16 test pairs a
     class, in deepim_tpu_torch/_build/phase9/; the same recipe file with
     network.pretrained cleared (the repo holds no pretrained FlowNet),
     TRAIN.end_epoch 2, global-norm clipping at 1.0 (see RECIPE_TCFG) and
     TEST.test_epoch 2; its LM6D_REFINE+LM6D_REFINE_SYN sets make an epoch of
     128 pairs (half data_syn), 32 steps of batch 4 x 4 inner iterations.
     A one-epoch warm-up on the real set alone, then train_net timed from
     seeded weights (bf16 network and image zoom, the driver's default;
     csr_raster, and nothing else, launched exactly the
     planned number of times; every loss finite, no dropped pair, every
     parameter moved, checkpoints for epochs 1 and 2), then test_deepim on
     the trained network (model=) and from the epoch-2 checkpoint, with
     equal tables.  It prints samples/s per epoch with the data path, the
     loop's time blocked on the loader beside its time in train steps, the
     decode cache's hits and misses, the checkpoint seconds, whether
     TensorBoard logs, and the test's frames/s;
 10. the engine's options at full width: refine at 480x640, batch 4, 4
     iterations, the full bf16 network on the 20,480-face CSR scene, once
     with box_observed masks, two per-class EULER head groups and depth
     input channels, once with input_mask=False (no mask channels, the zoom
     from the image foregrounds): finite orthonormal poses, csr_raster
     launched the planned number of times and nothing else;
 11. tracking and the refinement videos: (a) track_pairdb_sequence on a
     64x64 devkit (16 frames of an 80-face icosphere, 2 iterations a
     frame, the full network) on the card and on the CPU, fp32 to 1e-5
     frame by frame up to the first departure (a track is discontinuous
     where a pixel changes side), which may come no earlier than the CPU's
     own when frame 0's pose is nudged by 1e-7 m, and from there within
     twice the CPU's own gap; bf16 within 3x the CPU's own bf16-vs-fp32
     gap; (b) a 480x640 devkit of a 64-frame
     orbit a class (tests/test_tracker.py's path at LINEMOD depths, each
     initial pose perturbed as synth_data perturbs it) in
     deepim_tpu_torch/_build/phase11/, and tools/track_video.main for
     "sphere" (the 20,480-face icosphere alone in its bank: csr_raster) and
     "cube" (0.08 m: tile_raster) from a seeded bf16 checkpoint, with
     --iters-per-frame 2 --out <cls>.avi after a warm-up call; the
     class's kernel is held against its twin at the track's render
     (batch 1, the class alone in its bank, frame 0's pose); finite
     orthonormal poses, no dropped pair, the class's kernel launched 64 x 2
     (track) + 64 (overlay) times and nothing else, the AVI read back
     from its own header and index with 64 frames of 480x640; it prints
     tracked frames/s and ms a frame (the track alone), the decode and
     overlay seconds, one 16-frame track's device busy and idle share
     under torch.profiler, and the host synchronisations of a 2-frame
     track (torch.cuda.set_sync_debug_mode; none may come from
     engine/tracker.py itself); (c) the sphere's orbit
     tracked with tests/test_tracker.py's centroid oracle in place of the
     network from frame 0's gt pose: the mean translation error after
     frame 10 below half the static init's; (d) TEST.VIS_VIDEO through
     test_deepim on phase 8's devkit and output (pred_eval from its cached
     results_pose.pkl), csr_raster first held against its twin at each
     video's render (batch 8 of its class): video_cube.avi and
     video_sphere.avi with 8 pairs x 4 iterations = 32 frames of 960x1280,
     csr_raster launched the
     videos' planned count and nothing else; the seconds per video split
     into render, Canny and compose, and PNG encode.
 12. data parallelism: `python -m torch.distributed.run --standalone
     --nproc_per_node W chip_smoke.py --dp-rank <spec>` starts W ranks of
     the port's own entry points, one card each over NCCL where there are
     two cards or more (W = the cards), else two ranks sharing the one card
     over gloo (correctness only: no rate of that case is a scaling
     figure).  Each rank joins through parallel.initialize_distributed and
     (i) runs train_net on phase 9's recipe and devkit at a global batch of
     4 x W pairs (on gloo one epoch of the real set, 8 steps; on NCCL two
     epochs of both sets, the second timed as phase 9 times its epoch 2),
     then counts the host syncs of one DDP step and of one step alone (on
     NCCL also the cost of a DDP step: one gradient-sized all-reduce, DDP
     steps against steps alone on every rank at once, one DDP step under
     the profiler, and an epoch's rows stepped through without the loader); (ii) tracks W videos of the sphere (phase 11's
     orbit, each starting 8 frames later, frame 0 perturbed; 64 frames x 2
     iterations) with track_video_sharded, one a rank.  Checked: each
     rank's current card is its LOCAL_RANK's and every launch landed
     there; exactly the planned csr_raster launches on each rank and no
     other kernel; the ranks' parameters bit-equal (a hash) and their
     metrics equal; checkpoints written once, by rank 0; losses finite, no
     dropped pair; the parameters and losses against one process training
     on the global batch within 3x that process's own bf16-vs-fp32 gap
     (phase 7's bf16 rule: param_ratio, gap_ratio); each video's sharded track against its one-process track by
     phase 11's rule.  (iii) csr_raster held against its twin at rank 0's
     first render.  It prints `nvidia-smi topo -m`, samples/s per rank and
     epoch with the time blocked on the loader, the host syncs, the
     sharded track's frames/s against one process tracking the W videos as
     one batch, and on NCCL the scaling against one card (phase 9's cell).
Launch counters are zeroed just before each main-path phase and read just
after it.  The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deepim_tpu_torch.config import Config, TrainConfig, TrainIterConfig, load_config  # noqa: E402
from deepim_tpu_torch.config import update_config_dict, validate_config  # noqa: E402
from deepim_tpu_torch.data.pairdb import load_gt_pairdb  # noqa: E402
from deepim_tpu_torch.device import set_explicit_precision  # noqa: E402
from deepim_tpu_torch.engine import (  # noqa: E402
    TrainState,
    lr_steps_from_config,
    make_optimizer,
    make_train_step,
    warmup_multifactor_schedule,
)
from deepim_tpu_torch.engine.checkpoint import checkpoint_path, save_checkpoint  # noqa: E402
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation, refine  # noqa: E402
from deepim_tpu_torch.engine.refine import tune_raster_for_bank  # noqa: E402
from deepim_tpu_torch.engine.tester import pred_eval  # noqa: E402
from deepim_tpu_torch.engine.scene import LINEMOD_K, build_scene, train_batch  # noqa: E402
from deepim_tpu_torch.models.flownet import _ENCODER, FlowNetDeepIM, conv_out  # noqa: E402
from deepim_tpu_torch.ops.masks import box_fill  # noqa: E402
from deepim_tpu_torch.render import raster_kernels as rk  # noqa: E402
from deepim_tpu_torch.render.mesh import MeshBank, make_icosphere, make_test_cube  # noqa: E402
from deepim_tpu_torch.render.rasterizer import KERNELS, RasterConfig, kernel_inputs, rasterize  # noqa: E402
from deepim_tpu_torch.render.stress import stress_tile_list, stress_work_list  # noqa: E402
from deepim_tpu_torch.tools.synth_data import generate_dataset  # noqa: E402
from deepim_tpu_torch.tools import test_net as test_net_mod  # noqa: E402
from deepim_tpu_torch.tools import train_net as train_net_mod  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_deepim  # noqa: E402
from deepim_tpu_torch.tools.timing import graph_launch_ms  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model, train_net  # noqa: E402
from deepim_tpu_torch.utils.png import read_png, write_png  # noqa: E402
from deepim_tpu_torch.utils.tb import TBLogger  # noqa: E402

H, W = 480, 640
N_CALLS = 5
N_TURN_CALLS = 3      # timed calls (or steps) of each precision turn in phases 3 and 5
# Precision modes: (network dtype, image zoom dtype, cuDNN TF32).  "tf32" is
# what torch's defaults give an fp32 network (cuDNN TF32, cuBLAS fp32: the
# CLIs before they set the flags); "bf16" is the drivers' default on the card.
PRECISIONS = {"fp32": (torch.float32, "float32", False), "tf32": (torch.float32, "float32", True),
              "bf16": (torch.bfloat16, "bfloat16", False)}
TURNS = ("fp32", "tf32", "bf16", "bf16", "tf32", "fp32")
# Dense peaks of NVIDIA's H100 SXM data sheet for the convolution bound.
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
# Bound model (NVIDIA's H100 SXM data sheet): device memory at
# 3.35 TB/s, fp32 outside the tensor cores at 67 TFLOP/s.  A face-pixel
# evaluation is 22 fp32 operations (2 subtractions for dx/dy, 3 edge planes
# 10, the 1/z plane 4, its clamp 2, the inside test 3, the depth test 1).
# The CSR kernels are charged one at every pixel of the tile for every listed
# face: more than an algorithm that culls needs, and still below their bytes,
# so their bound is the byte bound either way.  tile_raster, whose heavy
# shape that count would put above its bytes, is charged what no algorithm
# can avoid: the 22 operations at each pixel a listed face really covers
# (counted from this run's inputs, covered_pairs) and 12 per listed face
# (its three edge planes once, to learn whether it touches the tile at all).
# csr_planes_raster reads 20 lanes (80 bytes) of raw row per face-tile pair
# and derives the planes with 78 operations per pair (area and sign 13,
# edge planes 12, the 1/z plane 10 and its clamp bounds 4, three colour
# planes 39).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_PAIR = 22
REC_BYTES = 4 * rk.REC_WIDTH
RAW_BYTES = 4 * 20
DERIVE_OPS = 78
OPS_PER_LISTED_FACE = 12
PLAIN = {"csr_raster": rk.csr_raster_plain, "csr_planes_raster": rk.csr_planes_raster_plain,
         "tile_raster": rk.tile_raster_plain}
REPLACES = {
    "csr_raster": "deepim_tpu/render/pallas_raster.py:117 (_csr_chunk_kernel, slots8)",
    "csr_planes_raster": "deepim_tpu/render/pallas_raster.py:240 (_csr_planes_kernel, planes64)",
    "tile_raster": "deepim_tpu/render/pallas_raster.py:66 (_tile_kernel)",
}
# The training recipe: experiments/deepim/cfgs/lm6d_ape_iter4_8epoch.yaml.
# The recipe fine-tunes pretrained FlowNet weights, which the repo does not
# hold; from seeded random weights its SGD diverges within three steps
# (the summed 480x640 mask loss drives the encoder; pm_loss reached inf on
# the H100), so the run adds the JAX package's from-scratch stabiliser,
# global-norm clipping at 1.0 (experiments/benchmark_multiclass.py:121).
TRAIN_B = 4           # TRAIN.BATCH_PAIRS
TRAIN_ITER_SIZE = 4   # network.TRAIN_ITER_SIZE
RECIPE_TICFG = TrainIterConfig(SE3_PM_LOSS=True, LW_PM=0.1, SE3_PM_LOSS_TYPE="L1",
                               NUM_3D_SAMPLE=3000, LW_FLOW=0.25, LW_MASK=0.03)
RECIPE_TCFG = TrainConfig(optimizer="sgd", warmup=True, warmup_lr=1e-5, warmup_step=200, lr=1e-4,
                          lr_step="4,6", momentum=0.975, wd=5e-4, grad_clip=1.0, BATCH_PAIRS=TRAIN_B,
                          FLOW_WEIGHT_TYPE="viz", UPDATE_MASK="box_gt")
PIXEL_MEANS = (123.68, 116.779, 103.939)
# (pack, tile_w) of the stress work lists: 4x4 cull blocks at tile_w 8 and
# 16, the kernels' general block shapes at 128 (16x1) and 2 (2x8).
STRESS_CASES = ((1, 8), (4, 8), (1, 16), (4, 16), (4, 128), (1, 2))
# (tile_h, tile_w) of the dense stress lists: 4x4 cull blocks in tiles of 64,
# 16, 8 and 2 blocks, and the general block shapes 16x1 (1x32) and 2x8 (16x6).
DENSE_STRESS_TILES = ((8, 128), (16, 16), (8, 16), (8, 4), (1, 32), (16, 6))
HEAVY_K_CAP = 512     # RasterConfig's default max_faces_per_tile
# Phase 8: the eval driver on a devkit written here (gitignored).
PHASE8_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase8")
EVAL_CFG = os.path.join(ROOT, "experiments", "deepim", "cfgs", "lm6d_ape_iter4_8epoch.yaml")
EVAL_B = 16           # test batch
EVAL_PAIRS = 256      # test pairs per class: 32 timed batches in all
# Phase 9: the training driver on a devkit of its own (gitignored).
PHASE9_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase9")
TRAIN_PAIRS = 32      # training pairs per class, read as LM6D_REFINE and as LM6D_REFINE_SYN
TRAIN_VAL_PAIRS = 16  # test pairs per class
TRAIN_EPOCHS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no GPU")
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median per-call time in ms, each call bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def covered_pairs(records, tf_global, counts, tile_xy, tile_h: int, tile_w: int) -> int:
    """The (face, pixel) pairs of a dense work list in which the listed face
    covers the pixel (the plain inside test on the card, 64 items at a time)."""
    k_max = int(counts.max())
    pos = torch.arange(k_max, device=counts.device)
    total = 0
    for w0 in range(0, counts.numel(), 64):
        sl = slice(w0, w0 + 64)
        live = pos[None, :] < counts[sl, None]
        px, py = rk._pixel_coords(tile_xy[sl], tile_h * tile_w, tile_w)
        inside, _ = rk._coverage(records[tf_global[sl, :k_max].long().clamp(min=0)], px, py)
        total += int((inside & live[..., None]).sum())
    return total


def bound(name: str, args) -> tuple[float, str, dict]:
    """Least time for this launch's work: bytes it must move (each face
    record or raw row once per tile it is binned to, the lists, the output)
    at 3.35 TB/s, or its operations at 67 TFLOP/s (see the bound model at
    the top for what each kernel is charged)."""
    if name in ("csr_raster", "csr_planes_raster"):
        _, _, _, seg_count, _, _, pack, _ = args
        n_items, pix = seg_count.numel(), rk.CSR_TILE_PIXELS
        units = int(seg_count.sum())
        faces = units * pack
        row = REC_BYTES if name == "csr_raster" else RAW_BYTES
        derive = 0 if name == "csr_raster" else faces * DERIVE_OPS
        nbytes = faces * row + units * 4 + n_items * (3 * 4 + 8) + n_items * 5 * pix * 4
        ops = faces * pix * OPS_PER_PAIR + derive
        info = {}
    else:
        _, _, counts, _, th, tw = args
        n_items, pix = counts.numel(), th * tw
        faces = int(counts.sum())
        nbytes = faces * (REC_BYTES + 4) + n_items * (4 + 8) + n_items * 4 * pix * 4
        covered = covered_pairs(*args) if faces else 0
        ops = covered * OPS_PER_PAIR + faces * OPS_PER_LISTED_FACE
        info = {"covered_face_pixel_pairs": covered}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    info.update(work_items=n_items, face_tile_pairs=faces, bytes=nbytes, ops=ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), info


def check_kernel(name: str, args, card: str, shape: str = "") -> dict:
    """Kernel vs plain twin on the same card inputs; times both.  `shape`
    names the inputs in the log where a kernel is held at more than one."""
    out = KERNELS[name](*args)
    ref = PLAIN[name](*args)
    torch.cuda.synchronize()
    q, q_ref = out[:, 0], ref[:, 0]
    hit = q > 0
    if not torch.equal(hit, q_ref > 0):
        raise AssertionError(f"{name}: hit masks differ in {int((hit != (q_ref > 0)).sum())} px")
    csr = name != "tile_raster"
    rgb_rows = slice(2, 5) if csr else slice(1, 4)
    if csr and not torch.equal(out[:, 1], ref[:, 1]):
        raise AssertionError(f"{name}: face ids differ in {int((out[:, 1] != ref[:, 1]).sum())} px")
    hit3 = hit[:, None].expand_as(out[:, rgb_rows])
    q_err = float((q - q_ref)[hit].abs().max()) if hit.any() else 0.0
    qs = torch.where(hit, q, torch.ones_like(q))[:, None]
    rgb_err = float(((out[:, rgb_rows] - ref[:, rgb_rows]) / qs)[hit3].abs().max()) if hit.any() else 0.0
    raw_err = float((out - ref)[hit[:, None].expand_as(out)].abs().max()) if hit.any() else 0.0
    if q_err > 1e-6 or rgb_err > 5e-3:
        raise AssertionError(f"{name}: q err {q_err}, rgb err {rgb_err}")
    ms = graph_launch_ms(lambda: KERNELS[name](*args))
    call_ms = cuda_ms(lambda: KERNELS[name](*args), reps=20)
    plain_ms = cuda_ms(lambda: PLAIN[name](*args), reps=10, warmup=1)
    b_ms, b_by, info = bound(name, args)
    # What the launch's time hangs on: how many items have faces, and their lists.
    faces = args[3][args[3] > 0].float() * args[6] if csr else args[2][args[2] > 0].float()
    info.update(nonempty_items=faces.numel(), mean_faces=round(float(faces.mean()), 1),
                max_faces=int(faces.max()))
    log(f"[{(name + ' ' + shape).strip()}] vs plain twin: {int(hit.sum())} hit px, max |dq| {q_err:.3g}, max |drgb| {rgb_err:.3g}, "
        f"max raw err {raw_err:.3g}; kernel {ms:.4f} ms per launch on the device ({call_ms:.4f} ms per single call "
        f"with its host share), twin {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
        f"({b_by}; {info}) [{card}]")
    return {"max_abs_err": raw_err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "out": out}


def stress_check(card: str) -> None:
    """Every kernel against its twin on the stress work lists: hits, face
    ids and every value exact (max abs error 0)."""
    for pack, tile_w in STRESS_CASES:
        records, raw, csr = stress_work_list(pack, tile_w, device="cuda")
        ref = rk.csr_raster_plain(records, *csr)
        for name, table in (("csr_raster", records), ("csr_planes_raster", raw)):
            out = KERNELS[name](table, *csr)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                bad = out != ref
                raise AssertionError(
                    f"{name} on the stress list (pack {pack}, tile_w {tile_w}): {int(bad.sum())} values "
                    f"differ in items {sorted(set(bad.nonzero()[:, 0].tolist()))}, "
                    f"{int((out[:, 1] != ref[:, 1]).sum())} face ids")
    log(f"[stress list] csr_raster and csr_planes_raster equal the twin bit for bit "
        f"((pack, tile_w) in {STRESS_CASES}; {int(csr[2].max()) * pack} faces in the longest item) [{card}]")
    for tile_h, tile_w in DENSE_STRESS_TILES:
        args = stress_tile_list(tile_h, tile_w, HEAVY_K_CAP, device="cuda")
        ref = rk.tile_raster_plain(*args)
        out = rk.tile_raster(*args)
        torch.cuda.synchronize()
        if not (ref[:, 0] > 0).any() or not torch.equal(out, ref):
            bad = out != ref
            raise AssertionError(
                f"tile_raster on the dense stress list (tile {tile_h}x{tile_w}): {int(bad.sum())} values "
                f"differ in items {sorted(set(bad.nonzero()[:, 0].tolist()))}")
    log(f"[stress list] tile_raster equals the twin bit for bit ((tile_h, tile_w) in {DENSE_STRESS_TILES}; "
        f"{int(args[2].max())} faces in the longest item) [{card}]")


def launch_counts() -> dict:
    return {name: KERNELS[name].launches for name in KERNELS}


def check_launches(label: str, counts: dict, expect: str, least: int) -> None:
    """`expect` launched at least `least` times in this phase, no other
    raster kernel at all."""
    if counts[expect] < least:
        raise AssertionError(f"{label}: {expect} launched {counts[expect]} times, want >= {least}")
    other = {k: v for k, v in counts.items() if k != expect and v}
    if other:
        raise AssertionError(f"{label}: other raster kernels launched on this path: {other}")


def make_model(pred_heads: bool, seed: int, dev, hw=(H, W), dtype=torch.float32, **net) -> FlowNetDeepIM:
    """Seeded random weights (equal for every dtype); a small nonzero
    translation head so the refined poses move (and, for an EULER head,
    which starts at zero, a small nonzero rotation head)."""
    g = torch.Generator().manual_seed(seed)
    model = FlowNetDeepIM(input_hw=hw, pred_flow=pred_heads, pred_mask=pred_heads, dtype=dtype, generator=g,
                          device=dev, **net)
    with torch.no_grad():
        model.trans.weight.copy_(torch.randn(model.trans.weight.shape, generator=g) * 1e-3)
        if model.rot_dim == 3:
            model.rot.weight.copy_(torch.randn(model.rot.weight.shape, generator=g) * 1e-3)
    return model.eval()


@contextlib.contextmanager
def precision(mode: str):
    """The flags of a PRECISIONS mode (cuDNN TF32 on for "tf32" only), and
    set_explicit_precision's again after."""
    set_explicit_precision()
    torch.backends.cudnn.allow_tf32 = PRECISIONS[mode][2]
    try:
        yield
    finally:
        set_explicit_precision()


def with_zoom(ecfg, mode: str):
    return dataclasses.replace(ecfg, zoom_dtype=PRECISIONS[mode][1])


def conv_flops(hw, in_ch: int, full: bool) -> tuple[float, float]:
    """Forward operations (2 per multiply-add) of one sample through the
    network's convolutions and transposed convolutions (the latter over
    their whole output, before the crop), and those of flow_conv1 alone
    (the one layer whose input gradient training does not need)."""
    h, w = hw
    sizes, total = {}, 0.0
    for name, cin, cout, k, s, p in _ENCODER:
        ho, wo = conv_out(h, k, s, p), conv_out(w, k, s, p)
        total += 2.0 * (cin or in_ch) * cout * k * k * ho * wo
        sizes[name], (h, w) = (ho, wo), (ho, wo)
    first = 2.0 * in_ch * 64 * 49 * sizes["flow_conv1"][0] * sizes["flow_conv1"][1]
    if full:
        (h6, w6), (h5, w5), (h4, w4) = sizes["conv6_1"], sizes["conv5_1"], sizes["conv4_1"]
        total += 2.0 * 1024 * 2 * 9 * h6 * w6                 # Convolution1
        total += 2.0 * (1024 * 512 + 2 * 2) * 16 * h6 * w6    # deconv5, upsample_flow6to5
        total += 2.0 * 1026 * 2 * 9 * h5 * w5                 # Convolution2
        total += 2.0 * (1026 * 256 + 2 * 2) * 16 * h5 * w5    # deconv4, upsample_flow5to4
        total += 2.0 * 770 * 3 * 9 * h4 * w4                  # Convolution3, mask_conv3
    return total, first


def conv_bound_ms(mode: str, hw, in_ch: int, full: bool, samples: int, train: bool) -> tuple[float, float]:
    """(operations, least ms) of the convolution family for `samples`
    sample-iterations at the card's dense peak for the mode; training adds
    each layer's input and weight gradients (twice the forward), less
    flow_conv1's input gradient."""
    fwd, first = conv_flops(hw, in_ch, full)
    ops = (3 * fwd - first if train else fwd) * samples
    return ops, ops / PEAK_OPS_PER_S[mode] * 1e3


def drive_main_path(label: str, scene, model, dev, card: str, expect: str, min_per_call: int, ecfg=None,
                    n_calls: int = N_CALLS) -> dict:
    """Chained refine() calls with the launch counters zeroed just before
    and read just after; checks poses and which kernel ran.  Returns the
    launch counts and the timed calls' median ms."""
    ecfg = scene.ecfg if ecfg is None else ecfg
    k = torch.from_numpy(LINEMOD_K).to(dev)
    obs = Observation(scene.image, box_fill(scene.mask), None, None, k)
    b = scene.image.shape[0]
    pose = torch.from_numpy(scene.pose0).to(dev)
    poses, times, dropped = [pose], [], []
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    for i in range(1 + n_calls):  # call 0 is the warm-up
        t0 = time.perf_counter()
        pose, _, stats = refine(model, obs, scene.meshes, pose, ecfg, with_stats=True, device=dev)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        poses.append(pose)
        dropped.append(stats["raster_dropped"])
    counts = launch_counts()
    check_launches(label, counts, expect, min_per_call * (1 + n_calls))
    stack = torch.stack(poses).cpu().numpy()
    if not np.isfinite(stack).all():
        raise AssertionError(f"{label}: non-finite poses")
    r = stack[-1][:, :, :3]
    orth = float(np.abs(r @ r.transpose(0, 2, 1) - np.eye(3)).max())
    if orth > 1e-4:
        raise AssertionError(f"{label}: rotations not orthonormal ({orth})")
    deltas = [float(np.abs(stack[i + 1] - stack[i]).max()) for i in range(len(stack) - 1)]
    if min(deltas) == 0.0:
        raise AssertionError(f"{label}: consecutive chained poses identical")
    n_drop = int(torch.stack(dropped).sum())
    if n_drop:
        raise AssertionError(f"{label}: CSR binning dropped {n_drop} face-tile pairs")
    ms = [t * 1e3 for t in times]
    mean_s = sum(times) / len(times)
    log(f"[{label}] refine x{ecfg.num_iters} iters, batch {b}: {statistics.median(ms):.2f} ms/call median "
        f"(min {min(ms):.2f}, max {max(ms):.2f}), {b / mean_s:.2f} frames/s; launches {counts}; "
        f"orthonormality err {orth:.2g}; min pose delta {min(deltas):.3g} [{card}]")
    return {"counts": counts, "ms": statistics.median(ms), "frames_s": b / mean_s}


_FAMILIES = (
    ("raster kernels", ("csr_raster", "csr_planes_raster", "tile_raster")),
    ("collectives", ("nccl",)),
    ("convolutions", ("conv", "xmma", "fprop", "implicit", "winograd", "cudnn", "dgrad", "wgrad",
                      "bprop", "backward")),
    ("matmuls", ("gemm", "cutlass", "cublas", "bmm")),
    ("sort/scan", ("sort", "radix", "scan")),
)


def refine_call(scene, model, dev, ecfg=None):
    """A closure running one refine() call of the scene."""
    ecfg = scene.ecfg if ecfg is None else ecfg
    k = torch.from_numpy(LINEMOD_K).to(dev)
    obs = Observation(scene.image, box_fill(scene.mask), None, None, k)
    pose = torch.from_numpy(scene.pose0).to(dev)
    return lambda: refine(model, obs, scene.meshes, pose, ecfg, device=dev)


def breakdown(label: str, fn, card: str) -> dict:
    """Device time of one fn() call by kernel family (torch.profiler), the
    device's idle share of the call's wall time, and the top kernels.
    Returns the families' device ms, 'busy' and 'wall'."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        # record_function ranges (Optimizer.step#SGD.step) carry the device
        # time of the kernels inside them: skip them, or it counts twice.
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy = sum(kernels.values())
    fam = {name: 0.0 for name, _ in _FAMILIES}
    fam["other (elementwise, index, copies)"] = 0.0
    for key, us in kernels.items():
        low = key.lower()
        hit = next((name for name, toks in _FAMILIES if any(t in low for t in toks)),
                   "other (elementwise, index, copies)")
        fam[hit] += us
    shares = ", ".join(f"{n} {us / 1e3:.2f} ms" for n, us in fam.items())
    log(f"[{label} breakdown] one call under the profiler: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (idle share {1 - busy / wall_us:.3f}); {shares} [{card}]")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[{label} breakdown]   {us / 1e3:8.3f} ms  {key[:110]}")
    return {**{n: us / 1e3 for n, us in fam.items()}, "busy": busy / 1e3, "wall": wall_us / 1e3}


def recipe_optimizer(model):
    """The recipe's SGD with its warmup schedule (update counts; the lr
    steps of epochs 4 and 6 lie far past this run)."""
    t = RECIPE_TCFG
    steps = lr_steps_from_config(t.lr_step, epoch_size=10_000)
    return make_optimizer(model.parameters(), t,
                          warmup_multifactor_schedule(t.lr, steps, 0.1, t.warmup, t.warmup_lr, t.warmup_step))


def train_setup(dev):
    """The training path's scene, batch and engine config: 480x640, batch
    4, 20,480-face icospheres, box_gt masks, the recipe's pixel means and
    flow normalisation, CSR renders through csr_planes_raster."""
    sc = build_scene(TRAIN_B, H, W, LINEMOD_K, num_iters=TRAIN_ITER_SIZE, mesh_detail=5,
                     update_mask="box_gt", device=dev)
    ecfg = dataclasses.replace(
        sc.ecfg, raster=dataclasses.replace(sc.ecfg.raster, csr_kernel="planes64"),
        pixel_means=PIXEL_MEANS, normalize_flow=20.0,
    )
    return sc, ecfg, train_batch(sc, LINEMOD_K, RECIPE_TICFG.NUM_3D_SAMPLE)


def drive_train(sc, ecfg, batch, dev, card: str, mode: str = "fp32", n_steps: int = N_CALLS) -> dict:
    """One warm-up and n_steps timed train steps of a `mode` network (see
    PRECISIONS) with the launch counters zeroed just before and read just
    after; checks losses, updates, the update count, dropped pairs and
    which raster kernel ran."""
    model = make_model(True, 2, dev, hw=(ecfg.height, ecfg.width), dtype=PRECISIONS[mode][0])
    state = TrainState(model, recipe_optimizer(model))
    step = make_train_step(with_zoom(ecfg, mode), RECIPE_TICFG, RECIPE_TCFG.FLOW_WEIGHT_TYPE, device=dev)
    before = [p.detach().clone() for p in model.parameters()]
    label = f"training path {mode}, planes64 (20,480-face meshes, full network, batch 4 x 4 inner)"
    history, times = [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    for i in range(1 + n_steps):  # step 0 is the warm-up
        t0 = time.perf_counter()
        state, metrics, _ = step(state, batch, sc.bank_arrays)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        history.append({k: v.cpu() for k, v in metrics.items()})
    counts = launch_counts()
    n_updates = TRAIN_ITER_SIZE * (1 + n_steps)
    check_launches(label, counts, "csr_planes_raster", n_updates)
    for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
        vals = torch.stack([h[key] for h in history])
        if vals.shape != (1 + n_steps, TRAIN_ITER_SIZE) or not torch.isfinite(vals).all():
            raise AssertionError(f"{label}: {key} not finite per inner iteration: {vals}")
    if state.step != n_updates or state.optimizer.count != n_updates:
        raise AssertionError(f"{label}: {state.step} iterations, {state.optimizer.count} updates, "
                             f"want {n_updates}")
    n_drop = int(sum(int(h["raster_dropped"].sum()) for h in history))
    if n_drop:
        raise AssertionError(f"{label}: CSR binning dropped {n_drop} face-tile pairs")
    moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, model.parameters()))
    if moved != len(before):
        raise AssertionError(f"{label}: {len(before) - moved} parameter tensors did not change")
    ms = [t * 1e3 for t in times]
    first = {k: float(v[0]) for k, v in history[0].items() if k != "raster_dropped"}
    last = {k: float(v[-1]) for k, v in history[-1].items() if k != "raster_dropped"}
    log(f"[{label}] {statistics.median(ms):.2f} ms/step median (min {min(ms):.2f}, max {max(ms):.2f}), "
        f"{TRAIN_B * len(times) / sum(times):.2f} samples/s, {n_updates} updates; launches {counts}; "
        f"first losses {first}; last losses {last}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return {"counts": counts, "step": lambda: step(state, batch, sc.bank_arrays), "ms": statistics.median(ms),
            "samples_s": TRAIN_B * len(times) / sum(times)}


def render_comparison(scene, dev, card: str) -> None:
    """One batch-16 CSR render of the eval scene, whole (glue included),
    with slots8 and with planes64: equal images, CUDA-event medians timed
    in turns (slots8, planes64, planes64, slots8)."""
    m = scene.meshes
    args = (m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(scene.pose0).to(dev),
            torch.from_numpy(LINEMOD_K).to(dev))
    cfgs = {k: dataclasses.replace(scene.ecfg.raster, csr_kernel=k) for k in ("slots8", "planes64")}
    outs = {k: rasterize(*args, c, corners=m.corners, corner_colors=m.corner_colors, device=dev)
            for k, c in cfgs.items()}
    for a, b in zip(outs["slots8"], outs["planes64"]):
        if not torch.equal(a, b):
            raise AssertionError("slots8 and planes64 renders differ")
    ms = {k: [] for k in cfgs}
    for k in ("slots8", "planes64", "planes64", "slots8"):
        ms[k].append(cuda_ms(lambda: rasterize(*args, cfgs[k], corners=m.corners,
                                               corner_colors=m.corner_colors, device=dev), reps=10))
    log(f"[render, batch {scene.image.shape[0]} CSR] slots8 {ms['slots8']} ms, planes64 {ms['planes64']} ms "
        f"per whole render (CUDA-event medians, two turns each); images equal [{card}]")


K64 = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
# bf16 card-vs-CPU tolerance: cuDNN sums in another order than the CPU, so
# bf16 roundings flip (as between the port and JAX on the CPU, where the
# difference measured 0.3 to 1.7 times the JAX package's own
# bf16-vs-fp32 gap, tests/test_torch_bf16.py); the card is held to this
# many times the CPU's own bf16-vs-fp32 gap on the same inputs.
BF16_GAP_FACTOR = 3.0


@contextlib.contextmanager
def driver_precision(mode: str):
    """The drivers' networks and image zoom in a PRECISIONS mode on every
    device, for the CPU-vs-card driver checks: the drivers build bf16
    networks and zoom in bf16 on the card and float32 on the CPU, so
    build_model's dtype, the eval network's dtype and from_config's zoom
    dtype are replaced for the block."""
    dtype, zoom, _ = PRECISIONS[mode]
    build, eval_dtype, from_config = train_net_mod.build_model, test_net_mod.EVAL_DTYPE, EngineConfig.from_config
    train_net_mod.build_model = lambda cfg, device="cuda": build(cfg, dtype=dtype, device=device)
    test_net_mod.EVAL_DTYPE = dtype
    EngineConfig.from_config = staticmethod(
        lambda *a, **kw: dataclasses.replace(from_config(*a, **kw), zoom_dtype=zoom))
    try:
        yield
    finally:
        train_net_mod.build_model, test_net_mod.EVAL_DTYPE = build, eval_dtype
        EngineConfig.from_config = staticmethod(from_config)


def gap_ratio(card, cpu, cpu_f32) -> float:
    """max |card - cpu| over the CPU's own bf16-vs-fp32 gap (max |cpu - cpu_f32|)."""
    return float(np.abs(card - cpu).max()) / max(float(np.abs(cpu - cpu_f32).max()), 1e-12)


def param_ratio(card: dict, cpu: dict, cpu_f32: dict, init: dict) -> tuple[float, str]:
    """The worst tensor's bf16 card-vs-CPU parameter difference, less 4 ulp
    of the tensor's magnitude, over the larger of the CPU's own bf16-vs-fp32
    difference of that tensor and 1% of its fp32 update (a tensor whose
    tiny update comes out the same in both precisions on the CPU has no
    gap to measure against: the card one float32 ulp away would be an
    infinite multiple of it)."""
    worst = (0.0, "")
    for k, ref in cpu.items():
        ref, c = np.asarray(ref), np.asarray(card[k])
        diff = float(np.abs(c - ref).max()) - 4 * float(np.spacing(np.float32(np.abs(ref).max())))
        scale = max(float(np.abs(ref - np.asarray(cpu_f32[k])).max()),
                    1e-2 * float(np.abs(np.asarray(cpu_f32[k]) - np.asarray(init[k])).max()), 1e-30)
        worst = max(worst, (max(diff, 0.0) / scale, k))
    return worst


def train_reference_check(dev) -> None:
    """One 2-inner-iteration train step of the 64x64 scene on the card and
    on the CPU, same weights.  fp32: losses to rtol 1e-4, parameters to
    1e-6 plus 1% of each tensor's update, final pose to 1e-5 (cuDNN sums in
    another order than the CPU; TF32 is off).  bf16 (network and image zoom
    on both sides): losses to rtol 1e-2, the pose within BF16_GAP_FACTOR
    times the CPU's own bf16-vs-fp32 difference, and parameters within 4
    ulp plus BF16_GAP_FACTOR times param_ratio's scale."""
    sc = build_scene(2, 64, 64, K64, num_iters=2, update_mask="box_gt", device="cpu")
    batch = train_batch(sc, K64, 16)
    ticfg = TrainIterConfig(SE3_PM_LOSS=True, LW_PM=0.1, NUM_3D_SAMPLE=16, LW_FLOW=0.25, LW_MASK=0.03)
    model0 = make_model(True, 5, "cpu", hw=(64, 64))
    out = {}
    for mode in ("fp32", "bf16"):
        for side, d in (("cpu", "cpu"), ("cuda", dev)):
            model = make_model(True, 5, d, hw=(64, 64), dtype=PRECISIONS[mode][0])
            opt = make_optimizer(model.parameters(), TrainConfig(), warmup_multifactor_schedule(1e-3, (1000,)))
            step = make_train_step(with_zoom(sc.ecfg, mode), ticfg, "viz", device=d)
            _, metrics, pose = step(TrainState(model, opt), batch, sc.bank_arrays)
            out[mode, side] = ({k: v.cpu().numpy() for k, v in metrics.items()},
                                               {k: v.cpu().numpy() for k, v in model.state_dict().items()},
                                               pose.cpu().numpy())
    p0 = {k: v.numpy() for k, v in model0.state_dict().items()}
    keys = ("pm_loss", "flow_loss", "mask_loss", "total")
    (m_c, p_c, pose_c), (m_g, p_g, pose_g) = out["fp32", "cpu"], out["fp32", "cuda"]
    loss_err = max(float(np.abs((m_g[k] - m_c[k]) / m_c[k]).max()) for k in keys)
    par_err = max(float(np.abs(p_g[k] - p_c[k]).max()) / (1e-6 + 1e-2 * float(np.abs(p_c[k] - p0[k]).max()))
                  for k in p_c)
    pose_err = float(np.abs(pose_g - pose_c).max())
    if loss_err > 1e-4 or par_err > 1.0 or pose_err > 1e-5:
        raise AssertionError(f"64x64 train step: card vs CPU loss rel err {loss_err}, parameter err "
                             f"{par_err} of its tolerance, pose err {pose_err}")
    log(f"[reference] 64x64 train step, 2 inner iterations, fp32: card vs CPU loss rel err {loss_err:.3g}, "
        f"parameter err {par_err:.3g} of tolerance, pose err {pose_err:.3g}")
    (b_c, q_c, bpose_c), (b_g, q_g, bpose_g) = out["bf16", "cpu"], out["bf16", "cuda"]
    loss_err = max(float(np.abs((b_g[k] - b_c[k]) / b_c[k]).max()) for k in keys)
    par_ratio, worst = param_ratio(q_g, q_c, p_c, p0)
    pose_ratio = gap_ratio(bpose_g, bpose_c, pose_c)
    if not np.isfinite(b_g["total"]).all() or loss_err > 1e-2 or max(par_ratio, pose_ratio) > BF16_GAP_FACTOR:
        raise AssertionError(f"64x64 train step bf16: card vs CPU loss rel err {loss_err}, parameters "
                             f"{par_ratio} ({worst}) and pose {pose_ratio} of the CPU's bf16-vs-fp32 gap")
    log(f"[reference] 64x64 train step, 2 inner iterations, bf16: card vs CPU loss rel err {loss_err:.3g}, "
        f"parameters {par_ratio:.3g} ({worst}) and pose {pose_ratio:.3g} of the CPU's bf16-vs-fp32 gap (limit "
        f"{BF16_GAP_FACTOR})")


# Each engine option of the phase-7 and phase-10 checks: EngineConfig fields
# and the network's input channels and heads.
OPTION_SETS = {
    "box_observed + 2 EULER head groups + input_depth": (
        dict(update_mask="box_observed", rot_type="EULER", input_depth=True),
        dict(in_channels=10, num_regressors=2, rot_dim=3)),
    "input_mask=False": (dict(input_mask=False), dict(in_channels=6)),
}


def option_observation(sc, k):
    """A scene's observation with everything the options read: observed
    depth and class ids."""
    return Observation(sc.image, box_fill(sc.mask), None, sc.depth, k,
                       torch.from_numpy(sc.cls_idx).to(sc.image.device))


def small_reference_checks(dev) -> None:
    """The card's path equals the CPU path on small inputs: renders of a
    CSR (ico4, 96x128) and a dense (64x64) scene; a 2-iteration refine of
    the 64x64 scene with the same weights in fp32 (pose to 1e-4) and in
    bf16 (network and image zoom; within BF16_GAP_FACTOR times the CPU's own
    bf16-vs-fp32 pose gap); and a 2-iteration fp32 refine with each engine
    option (pose to 1e-4)."""
    k96 = np.array([[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]], np.float32)
    for hw, kk, detail in (((96, 128), k96, 4), ((64, 64), K64, 2)):
        sc = build_scene(2, *hw, kk, num_iters=2, mesh_detail=detail, device="cpu")
        m = sc.meshes
        args = (m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0),
                torch.from_numpy(kk), sc.ecfg.raster)
        rgb_g, depth_g = rasterize(*args, device=dev)
        rgb_c, depth_c = rasterize(*args, device="cpu")
        if not torch.equal(depth_g.cpu() > 0, depth_c > 0):
            raise AssertionError(f"{hw}: card and CPU hit masks differ")
        d_err = float((depth_g.cpu() - depth_c).abs().max())
        c_err = float((rgb_g.cpu() - rgb_c).abs().max())
        if d_err > 1e-5 or c_err > 5e-3:
            raise AssertionError(f"{hw}: card vs CPU depth {d_err}, rgb {c_err}")
        log(f"[reference] {hw} render (detail {detail}): card == CPU hit mask, depth err {d_err:.3g}, rgb err {c_err:.3g}")
    sc = build_scene(2, 64, 64, K64, num_iters=2, device="cpu")
    obs = Observation(sc.image, box_fill(sc.mask), None, None, torch.from_numpy(K64))
    poses = {}
    for mode in ("fp32", "bf16"):
        ecfg = with_zoom(sc.ecfg, mode)
        for side, d in (("cpu", "cpu"), ("cuda", dev)):
            model = make_model(True, seed=5, dev=d, hw=(64, 64), dtype=PRECISIONS[mode][0])
            poses[mode, side] = refine(model, obs, sc.meshes, torch.from_numpy(sc.pose0), ecfg,
                                                       device=d)[1].cpu().numpy()
    err = float(np.abs(poses["fp32", "cuda"] - poses["fp32", "cpu"]).max())
    if not np.isfinite(poses["fp32", "cuda"]).all() or err > 1e-4:
        raise AssertionError(f"64x64 refine: card vs CPU pose err {err}")
    ratio = gap_ratio(poses["bf16", "cuda"], poses["bf16", "cpu"], poses["fp32", "cpu"])
    if not np.isfinite(poses["bf16", "cuda"]).all() or ratio > BF16_GAP_FACTOR:
        raise AssertionError(f"64x64 refine bf16: card vs CPU pose diff {ratio} of the CPU's bf16-vs-fp32 gap")
    log(f"[reference] 64x64 refine, 2 iterations: fp32 card vs CPU pose err {err:.3g}; bf16 card vs CPU pose "
        f"diff {ratio:.3g} of the CPU's bf16-vs-fp32 gap (limit {BF16_GAP_FACTOR})")
    for name, (fields, net) in OPTION_SETS.items():
        sc = build_scene(2, 64, 64, K64, num_iters=2, update_mask=fields.get("update_mask", "box_rendered"),
                         device="cpu")
        ecfg = dataclasses.replace(sc.ecfg, **fields)
        obs = option_observation(sc, torch.from_numpy(K64))
        out = [refine(make_model(True, 8, d, hw=(64, 64), **net), obs, sc.meshes, torch.from_numpy(sc.pose0),
                      ecfg, device=d)[1].cpu() for d in ("cpu", dev)]
        err = float((out[1] - out[0]).abs().max())
        if not torch.isfinite(out[1]).all() or err > 1e-4:
            raise AssertionError(f"64x64 refine with {name}: card vs CPU pose err {err}")
        log(f"[reference] 64x64 refine, 2 iterations, {name}, fp32: card vs CPU pose err {err:.3g}")
    train_reference_check(dev)


def _table_rows(results: dict, classes, num_iters: int):
    """(table, class, iteration, row) of the 5cm5deg, ADD(-S) and Proj2D
    tables; raises if a class, an iteration or a key is missing."""
    keys = {"pose": ("rot_acc", "trans_acc", "space_acc", "acc_5cm_5deg"),
            "add": ("0.02", "0.05", "0.10", "auc", "errors"),
            "arp_2d": ("2", "5", "10", "20", "auc", "errors", "curve", "curve_thresholds")}
    for table, want in keys.items():
        for cls in classes:
            for it in range(num_iters):
                row = results[table][cls][it]
                missing = set(want) - set(row)
                if missing:
                    raise AssertionError(f"{table} {cls} iter {it + 1}: keys {sorted(missing)} missing")
                yield table, cls, it, row


def check_tables(label: str, results: dict, classes, num_iters: int) -> None:
    for table, cls, it, row in _table_rows(results, classes, num_iters):
        for key, v in row.items():
            if not np.isfinite(np.asarray(v, np.float64)).all():
                raise AssertionError(f"{label}: {table} {cls} iter {it + 1} {key} not finite")


def small_driver_check(dev) -> None:
    """pred_eval on a 64x64 devkit (a cube and an 80-face icosphere, dense
    tile_raster renders) on the card and on the CPU with the same FAST_TEST
    weights: fp32 per-iteration poses to 2e-4, as the tests hold the CPU
    path to the JAX package; bf16 (network and image zoom on both sides)
    within BF16_GAP_FACTOR times the CPU's own bf16-vs-fp32 gap."""
    import pickle

    k64 = K64
    devkit = os.path.join(PHASE8_DIR, "devkit64")
    generate_dataset(devkit, {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 1)}, k64,
                     n_train=0, n_val=5, height=64, width=64, z_range=(0.45, 0.6),
                     raster_cfg=RasterConfig(height=64, width=64, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                             chunk=16, znear=0.05, zfar=10.0), device="cpu")
    cfg = update_config_dict(Config(), {
        "SCALES": [64, 64],
        "dataset": {"dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": ["cube", "sphere"], "INTRINSIC_MATRIX": k64.flatten().tolist(),
                    "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0},
        "network": {"INPUT_MASK": True, "PIXEL_MEANS": list(PIXEL_MEANS)},
        "TEST": {"test_iter": 4, "FAST_TEST": True},
    })
    dbs = [load_gt_pairdb(cfg, "LM6D_REFINE", f"val_{c}", c, devkit, devkit) for c in ("cube", "sphere")]
    bank = build_mesh_bank(cfg)
    poses = {}
    for mode in ("fp32", "bf16"):
        model = make_model(False, 6, "cpu", hw=(64, 64), dtype=PRECISIONS[mode][0])
        for side, d in (("cpu", "cpu"), ("cuda", dev)):
            out = os.path.join(PHASE8_DIR, f"small_{mode}_{side}")
            with driver_precision(mode):
                pred_eval(cfg, model.to(d), dbs, bank, out, batch_size=4, device=d)
            with open(os.path.join(out, "results_pose.pkl"), "rb") as f:
                poses[mode, side] = np.stack([np.stack(per_it) for per_cls in pickle.load(f)[0]
                                                              for per_it in per_cls])
    err = float(np.abs(poses["fp32", "cuda"] - poses["fp32", "cpu"]).max())
    if not np.isfinite(poses["fp32", "cuda"]).all() or err > 2e-4:
        raise AssertionError(f"64x64 eval driver: card vs CPU pose err {err}")
    ratio = gap_ratio(poses["bf16", "cuda"], poses["bf16", "cpu"], poses["fp32", "cpu"])
    if not np.isfinite(poses["bf16", "cuda"]).all() or ratio > BF16_GAP_FACTOR:
        raise AssertionError(f"64x64 eval driver bf16: card vs CPU pose diff {ratio} of the CPU's bf16-vs-fp32 gap")
    log(f"[reference] 64x64 eval driver (pred_eval, 2 classes x 5 pairs, 4 iterations): fp32 card vs CPU pose "
        f"err {err:.3g}; bf16 card vs CPU pose diff {ratio:.3g} of the CPU's bf16-vs-fp32 gap (limit "
        f"{BF16_GAP_FACTOR})")


def small_train_driver_check(dev) -> None:
    """One epoch of train_net on a 64x64 devkit (a cube and an 80-face
    icosphere, 4 training pairs a class read as LM6D_REFINE and as
    LM6D_REFINE_SYN: 4 steps of batch 4 x 2 inner iterations, dense
    tile_raster renders) on the card and on the CPU from the same initial
    weights, in fp32 and in bf16 (driver_precision): every inner
    iteration's losses and the parameters after the epoch to
    train_reference_check's tolerances (param_ratio for bf16)."""
    k64 = K64
    devkit = os.path.join(PHASE9_DIR, "devkit64")
    generate_dataset(devkit, {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 1)}, k64,
                     n_train=4, n_val=0, height=64, width=64, z_range=(0.45, 0.6),
                     raster_cfg=RasterConfig(height=64, width=64, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                             chunk=16, znear=0.05, zfar=10.0), device="cpu")
    cfg = update_config_dict(Config(), {
        "SCALES": [64, 64],
        "dataset": {"dataset": "LM6D_REFINE+LM6D_REFINE_SYN", "image_set": "train_+train_",
                    "dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": ["cube", "sphere"], "INTRINSIC_MATRIX": k64.flatten().tolist(),
                    "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0},
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True, "TRAIN_ITER": True,
                    "TRAIN_ITER_SIZE": 2, "PIXEL_MEANS": list(PIXEL_MEANS)},
        "train_iter": {"SE3_PM_LOSS": True, "LW_PM": 0.1, "NUM_3D_SAMPLE": 16, "LW_FLOW": 0.25, "LW_MASK": 0.03},
        "TRAIN": {"BATCH_PAIRS": 4, "end_epoch": 1, "lr": 1e-4, "lr_step": "", "INIT_MASK": "box_gt",
                  "UPDATE_MASK": "box_gt", "MASK_DILATE": True, "FLOW_WEIGHT_TYPE": "viz"},
    })
    init = make_model(True, 5, "cpu", hw=(64, 64)).state_dict()
    runs = {}
    for mode in ("fp32", "bf16"):
        for side, d in (("cpu", "cpu"), ("cuda", dev)):
            with driver_precision(mode):
                state = train_net(cfg, output_dir=os.path.join(PHASE9_DIR, f"small_{mode}_{side}"),
                                  device=d, init_state_dict=init)
            runs[mode, side] = (state.epochs[0]["metrics"],
                                                {k: v.cpu() for k, v in state.model.state_dict().items()})
    (m_c, p_c), (m_g, p_g) = runs["fp32", "cpu"], runs["fp32", "cuda"]
    keys = ("pm_loss", "flow_loss", "mask_loss", "total")
    for (m, _) in runs.values():
        if any(m[k].shape != (4, 2) or not np.isfinite(m[k]).all() for k in keys):
            raise AssertionError(f"64x64 train_net: losses {m}")
    loss_err = max(float((np.abs(m_g[k] - m_c[k]) / np.abs(m_c[k])).max()) for k in keys)
    par_err = max(float((p_g[k] - p_c[k]).abs().max()) / (1e-6 + 1e-2 * float((p_c[k] - init[k]).abs().max()))
                  for k in p_c)
    if loss_err > 1e-4 or par_err > 1.0:
        raise AssertionError(f"64x64 train_net epoch: card vs CPU loss rel err {loss_err}, parameter err "
                             f"{par_err} of its tolerance")
    (b_c, q_c), (b_g, q_g) = runs["bf16", "cpu"], runs["bf16", "cuda"]
    bf_loss_err = max(float((np.abs(b_g[k] - b_c[k]) / np.abs(b_c[k])).max()) for k in keys)
    par_ratio, worst = param_ratio(q_g, q_c, p_c, init)
    if bf_loss_err > 1e-2 or par_ratio > BF16_GAP_FACTOR:
        raise AssertionError(f"64x64 train_net epoch bf16: card vs CPU loss rel err {bf_loss_err}, parameters "
                             f"{par_ratio} ({worst}) of the CPU's bf16-vs-fp32 gap")
    log(f"[reference] 64x64 train_net, one epoch (4 steps x 2 inner iterations): fp32 card vs CPU loss rel err "
        f"{loss_err:.3g}, parameter err {par_err:.3g} of tolerance; bf16 card vs CPU loss rel err "
        f"{bf_loss_err:.3g}, parameters {par_ratio:.3g} ({worst}) of the CPU's bf16-vs-fp32 gap (limit "
        f"{BF16_GAP_FACTOR})")


def write_devkit(devkit: str, n_train: int, n_val: int, dev, card: str, label: str) -> None:
    """A phase-8/9 devkit: 480x640, LINEMOD intrinsics, a cube and a
    20,480-face icosphere, n_train training and n_val test pairs each.  Its
    renders use a CSR budget tuned to the two meshes, so none drops a face."""
    meshes = {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 5)}
    bank = MeshBank.from_meshes([meshes[c] for c in sorted(meshes)]).arrays()
    raster = tune_raster_for_bank(EngineConfig(raster=RasterConfig(height=H, width=W)), bank, LINEMOD_K).raster
    t0 = time.perf_counter()
    generate_dataset(devkit, meshes, LINEMOD_K, n_train=n_train, n_val=n_val, height=H, width=W,
                     raster_cfg=raster, device=dev)
    n_png = sum(len(files) for _, _, files in os.walk(os.path.join(devkit, "data")) if files)
    log(f"[{label}] devkit: 2 classes x ({n_train} training + {n_val} test) pairs at {H}x{W}, {n_png} files under "
        f"data/, written in {time.perf_counter() - t0:.2f} s [{card}]")


def eval_config(devkit: str, out_root: str):
    """lm6d_ape_iter4_8epoch.yaml through the port's reader, pointed at the
    devkit's two classes and its val_ test lists."""
    cfg = update_config_dict(load_config(EVAL_CFG), {
        "output_path": out_root,
        "dataset": {"dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": ["cube", "sphere"], "NUM_CLASSES": 2, "test_image_set": "val_"},
    })
    return validate_config(cfg)


def decode_costs(devkit: str, card: str) -> dict:
    """read_png's time per 480x640 image: the devkit's files (Sub rows) and
    one colour image re-encoded with each row filter."""
    out = {}
    obs = os.path.join(devkit, "data", "observed")
    for kind in ("color", "depth", "label"):
        files = sorted(os.path.join(r, f) for r, _, fs in os.walk(obs) for f in fs if f.endswith(f"-{kind}.png"))
        times = []
        for path in files[:8]:
            t0 = time.perf_counter()
            read_png(path)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"devkit {kind} (Sub)"] = statistics.median(times)
    img = read_png(os.path.join(obs, "sphere", "000000-color.png"))
    tmp = os.path.join(PHASE8_DIR, "filter.png")
    for ft, name in enumerate(("None", "Sub", "Up", "Average", "Paeth")):
        write_png(tmp, img, filter_type=ft)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            back = read_png(tmp)
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(back, img):
            raise AssertionError(f"read_png: filter {name} did not round-trip")
        out[f"colour, every row {name} ({ft})"] = min(times)
    log(f"[eval driver] PNG decode ms per {H}x{W} image (read_png, host CPU): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()) + f" [{card}]")
    return out


def drive_eval_driver(dev, card: str) -> dict:
    """Phase 8 (see the module docstring).  Returns csr_raster's check at
    the driver's render shape and the timed run's launch count."""
    devkit = os.path.join(PHASE8_DIR, "devkit")
    write_devkit(devkit, 0, EVAL_PAIRS, dev, card, "eval driver")
    cfg = eval_config(devkit, os.path.join(PHASE8_DIR, "output"))
    classes = list(cfg.dataset.class_name)
    n_iter = cfg.TEST.test_iter

    # One render's plan at the driver's config: its launches, and csr_raster
    # held against its twin at the driver's shape.
    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, bank_arrays=bank)
    _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit)
    m = MeshBuffers.gather(bank, np.full(EVAL_B, classes.index("sphere")), device=dev)
    plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                         torch.from_numpy(np.stack([r["pose_rendered"] for r in recs[:EVAL_B]])),
                         torch.from_numpy(cfg.dataset.intrinsic_matrix()), ecfg.raster, corners=m.corners,
                         corner_colors=m.corner_colors, device=dev)
    if {name for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"eval driver: a render plans {[name for name, _ in plan]}")
    kernel = check_kernel("csr_raster", plan[0][1], card, shape="eval driver")
    n_batches = len(classes) * math.ceil(EVAL_PAIRS / EVAL_B)
    expect = len(plan) * n_iter * n_batches

    model = make_model(True, 3, dev, hw=(cfg.height, cfg.width))
    runs = {}
    for name in ("warm-up", "timed"):
        out = os.path.join(PHASE8_DIR, "output", name)
        save_checkpoint(os.path.join(out, cfg.TRAIN.model_prefix), cfg.TEST.test_epoch, TrainState(model, None))
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        res = test_deepim(cfg, output_dir=out, batch_size=EVAL_B, device=dev)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t0, launch_counts())
    res, wall, counts = runs["timed"]
    label = "eval driver"
    if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"{label}: launches {counts}, want csr_raster {expect} ({len(plan)} a render x "
                             f"{n_iter} iterations x {n_batches} batches) and nothing else")
    run = res["run"]
    if run["pairs"] != len(classes) * EVAL_PAIRS or run["raster_dropped"]:
        raise AssertionError(f"{label}: {run}")
    check_tables(label, res, classes, n_iter)

    rk.reset_launch_counts()
    cached = test_deepim(cfg, output_dir=os.path.join(PHASE8_DIR, "output", "timed"), batch_size=EVAL_B,
                         device=dev)
    if any(launch_counts().values()) or "run" in cached:
        raise AssertionError(f"{label}: the cached run refined again ({launch_counts()})")
    for (_, cls, it, row), (_, _, _, row2) in zip(_table_rows(res, classes, n_iter),
                                                  _table_rows(cached, classes, n_iter)):
        if any(not np.array_equal(np.asarray(row[k]), np.asarray(row2[k])) for k in row):
            raise AssertionError(f"{label}: cached tables differ ({cls} iter {it + 1})")

    loop_s = run["data_s"] + run["net_s"]
    means = {t: {k: float(np.mean([res[t][c][n_iter - 1][k] for c in classes])) for k in keys}
             for t, keys in (("pose", ("acc_5cm_5deg",)), ("add", ("0.10", "auc")), ("arp_2d", ("5", "auc")))}
    log(f"[{label}] test_deepim, {run['pairs']} pairs at {H}x{W}, batch {EVAL_B} ({n_batches} batches), "
        f"{n_iter} iterations: {run['pairs'] / loop_s:.2f} frames/s over pred_eval's loop (data "
        f"{run['data_s']:.3f} s + net {run['net_s']:.3f} s); launches {counts} (planned {len(plan)} a render); "
        f"dropped pairs 0; iteration {n_iter} class means {means}; cached rerun: 0 launches, equal tables "
        f"[{card}]")
    log(f"[{label}] the timed call's stages (s, test_deepim's run dict): "
        + ", ".join(f"{k} {v:.3f}" for k, v in run.items() if k.endswith("_s"))
        + f"; the whole call {wall:.3f} s, the warm-up call {runs['warm-up'][1]:.3f} s [{card}]")
    decode_costs(devkit, card)
    kernel["launches"] = counts["csr_raster"]
    return kernel


def train_driver_config(devkit: str, out_root: str, **train):
    """lm6d_ape_iter4_8epoch.yaml through the port's reader, pointed at the
    phase-9 devkit, trained from seeded weights for TRAIN_EPOCHS epochs
    with global-norm clipping (RECIPE_TCFG), tested at the last epoch."""
    cfg = update_config_dict(load_config(EVAL_CFG), {
        "output_path": out_root,
        "dataset": {"dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": ["cube", "sphere"], "NUM_CLASSES": 2, "test_image_set": "val_"},
        "network": {"pretrained": ""},
        "TRAIN": {"end_epoch": TRAIN_EPOCHS, "grad_clip": RECIPE_TCFG.grad_clip, **train},
        "TEST": {"test_epoch": TRAIN_EPOCHS},
    })
    return validate_config(cfg)


def drive_train_driver(dev, card: str) -> dict:
    """Phase 9 (see the module docstring).  Returns csr_raster's check at
    the training driver's render shape and the timed run's launch count."""
    devkit = os.path.join(PHASE9_DIR, "devkit")
    label = "train driver"
    write_devkit(devkit, TRAIN_PAIRS, TRAIN_VAL_PAIRS, dev, card, label)
    out = os.path.join(PHASE9_DIR, "output")
    cfg = train_driver_config(devkit, out)
    classes = list(cfg.dataset.class_name)
    b, n_inner = cfg.TRAIN.BATCH_PAIRS, cfg.network.TRAIN_ITER_SIZE

    # One render's plan at the driver's config and batch, and csr_raster
    # held against its twin there.
    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=bank)
    _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", "train_sphere", "sphere", devkit, devkit)
    m = MeshBuffers.gather(bank, np.full(b, classes.index("sphere")), device=dev)
    plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                         torch.from_numpy(np.stack([r["pose_rendered"] for r in recs[:b]])),
                         torch.from_numpy(cfg.dataset.intrinsic_matrix()), ecfg.raster, corners=m.corners,
                         corner_colors=m.corner_colors, device=dev)
    if {name for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"{label}: a render plans {[name for name, _ in plan]}")
    kernel = check_kernel("csr_raster", plan[0][1], card, shape=label)

    warm = train_driver_config(devkit, out, end_epoch=1, model_prefix="warmup")
    warm = update_config_dict(warm, {"dataset": {"dataset": "LM6D_REFINE", "image_set": "train_"}})
    t0 = time.perf_counter()
    train_net(warm, output_dir=os.path.join(out, "warm-up"), device=dev)
    warm_s = time.perf_counter() - t0

    init = build_model(cfg, device="cpu").state_dict()
    train_dir = os.path.join(out, "train")
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    state = train_net(cfg, output_dir=train_dir, device=dev, init_state_dict=init)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = TRAIN_EPOCHS * len(classes) * 2 * TRAIN_PAIRS // b
    expect = len(plan) * n_inner * steps
    if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"{label}: launches {counts}, want csr_raster {expect} ({len(plan)} a render x "
                             f"{n_inner} inner iterations x {steps} steps) and nothing else")
    epochs = state.epochs
    if [e["epoch"] for e in epochs] != list(range(1, TRAIN_EPOCHS + 1)):
        raise AssertionError(f"{label}: epochs logged {epochs}")
    for e in epochs:
        if e["nonfinite_losses"] or e["raster_dropped"]:
            raise AssertionError(f"{label}: epoch {e['epoch']}: {e['nonfinite_losses']} non-finite loss values, "
                                 f"{e['raster_dropped']} dropped face-tile pairs")
    if state.step != steps * n_inner or state.optimizer.count != steps * n_inner:
        raise AssertionError(f"{label}: {state.step} iterations, {state.optimizer.count} updates, want "
                             f"{steps * n_inner}")
    params = state.model.state_dict()
    still = [k for k, v in init.items() if torch.equal(v, params[k].cpu())]
    if still or not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError(f"{label}: parameters not moved {still} or not finite")
    prefix = os.path.join(train_dir, cfg.TRAIN.model_prefix)
    missing = [e for e in range(1, TRAIN_EPOCHS + 1) if not os.path.isfile(checkpoint_path(prefix, e))]
    if missing:
        raise AssertionError(f"{label}: no checkpoint for epochs {missing}")

    t0 = time.perf_counter()
    handed = test_deepim(cfg, output_dir=os.path.join(out, "test_model"), batch_size=EVAL_B, device=dev,
                         model=state.model)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    loaded = test_deepim(cfg, output_dir=train_dir, batch_size=EVAL_B, device=dev)
    n_iter = cfg.TEST.test_iter
    check_tables(label, handed, classes, n_iter)
    for (_, cls, it, row), (_, _, _, row2) in zip(_table_rows(handed, classes, n_iter),
                                                  _table_rows(loaded, classes, n_iter)):
        if any(not np.array_equal(np.asarray(row[k]), np.asarray(row2[k])) for k in row):
            raise AssertionError(f"{label}: tables from model= and from the checkpoint differ ({cls} iter {it + 1})")

    tb = TBLogger(os.path.join(PHASE9_DIR, "tb_probe"), enabled=cfg.TRAIN.TENSORBOARD_LOG)
    tb_active = tb.enabled
    tb.close()
    for e in epochs:
        log(f"[{label}] epoch {e['epoch']}: {e['samples']} samples in {e['loop_s']:.3f} s, "
            f"{e['samples'] / e['loop_s']:.2f} samples/s with the data path ({b} pairs x {n_inner} inner "
            f"iterations a step); blocked on the loader {e['wait_s']:.3f} s, in train steps {e['step_s']:.3f} s; "
            f"decode cache {e['cache_hits']} hits, {e['cache_misses']} misses; checkpoint {e['checkpoint_s']:.3f} s "
            f"[{card}]")
    run = handed["run"]
    log(f"[{label}] train_net {TRAIN_EPOCHS} epochs at {H}x{W}, {steps} steps: {wall:.3f} s in all (warm-up call "
        f"{warm_s:.3f} s); launches {counts} (planned {len(plan)} a render); TensorBoard "
        f"{'active' if tb_active else 'not active (no tensorboard package)'}; every loss finite, 0 dropped pairs, "
        f"every parameter moved; checkpoints for epochs 1-{TRAIN_EPOCHS} [{card}]")
    log(f"[{label}] test_deepim(model=): {run['pairs']} pairs, {run['pairs'] / (run['data_s'] + run['net_s']):.2f} "
        f"frames/s over pred_eval's loop (data {run['data_s']:.3f} s + net {run['net_s']:.3f} s), the call "
        f"{test_s:.3f} s; equal tables from the epoch-{TRAIN_EPOCHS} checkpoint [{card}]")
    kernel["launches"] = counts["csr_raster"]
    return kernel


def drive_options(dev, card: str) -> None:
    """Phase 10 (see the module docstring): each OPTION_SETS entry once,
    with the launch counters zeroed just before the refine and read just
    after."""
    k = torch.from_numpy(LINEMOD_K).to(dev)
    for i, (name, (fields, net)) in enumerate(OPTION_SETS.items()):
        label = f"options at {H}x{W}: {name}"
        sc = build_scene(4, H, W, LINEMOD_K, num_iters=4, mesh_detail=5,
                         update_mask=fields.get("update_mask", "box_rendered"), device=dev)
        ecfg = dataclasses.replace(sc.ecfg, zoom_dtype="bfloat16", **fields)
        model = make_model(True, 9 + i, dev, hw=(H, W), dtype=torch.bfloat16, **net)
        m = sc.meshes
        plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0), k,
                             ecfg.raster, corners=m.corners, corner_colors=m.corner_colors, device=dev)
        if {n for n, _ in plan} != {"csr_raster"}:
            raise AssertionError(f"{label}: a render plans {[n for n, _ in plan]}")
        expect = len(plan) * ecfg.num_iters
        obs = option_observation(sc, k)
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        final, poses, stats = refine(model, obs, sc.meshes, torch.from_numpy(sc.pose0), ecfg, with_stats=True,
                                     device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
            raise AssertionError(f"{label}: launches {counts}, want csr_raster {expect} and nothing else")
        poses = poses.cpu().numpy()
        r = poses[..., :3]
        orth = float(np.abs(r @ np.swapaxes(r, -1, -2) - np.eye(3)).max())
        moved = float(np.abs(poses[-1] - sc.pose0).max())
        if not np.isfinite(poses).all() or orth > 1e-4 or moved == 0.0 or int(stats["raster_dropped"]):
            raise AssertionError(f"{label}: finite {np.isfinite(poses).all()}, orthonormality err {orth}, "
                                 f"moved {moved}, dropped {int(stats['raster_dropped'])}")
        log(f"[{label}] refine x{ecfg.num_iters} iters, batch 4, bf16 network ({net}) and zoom: {wall * 1e3:.2f} "
            f"ms (first call, cold); launches {counts}; orthonormality err {orth:.2g}; pose moved {moved:.3g} "
            f"[{card}]")



# Phase 11: tracking and the refinement videos.
PHASE11_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase11")
TRACK_T = 64          # frames of each full-width orbit
TRACK_ITERS = 2       # refinement iterations a frame (--iters-per-frame)
TRACK_PROFILE_T = 16  # frames of the profiled track
SMALL_TRACK_T = 16    # frames of the 64x64 card-vs-CPU track
# A rounding-level nudge of frame 0's translation (about 2 float32 ulps at
# these depths): a track is a chain of steps that are discontinuous where a
# pixel changes side (the box of the rendered mask), so two devices that
# round differently can part after a flip.  The card is held to
# SMALL_TRACK_TOL frame by frame up to its first departure from the CPU; it
# may depart no earlier than the CPU departs from itself under this nudge,
# and from there it is held to twice the CPU's own gap
# (tests/test_torch_tracker.py).
ROUNDING_NUDGE = 1e-7
SMALL_TRACK_TOL = 1e-5
VIDEO_PAIRS = 8       # gen_refine_video's num_pairs default
# A kernel's figures at a driver's render, as the kernels line carries them.
CHECK_KEYS = ("launches", "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")


def orbit_poses(n: int) -> np.ndarray:
    """tests/test_tracker.py:make_orbit's Lissajous path at LINEMOD depths
    (0.8 m +- 0.09, lateral amplitudes scaled by 0.8 / 0.55 from its
    0.55 m), turning slowly about each axis: (n, 3, 4) poses."""
    from scipy.spatial.transform import Rotation

    t = np.arange(n, dtype=np.float64)
    poses = np.zeros((n, 3, 4), np.float32)
    poses[:, :, :3] = Rotation.from_euler("xyz", np.stack([0.4 + 0.01 * t, -0.3 + 0.015 * t, 0.2 + 0.0 * t], 1)
                                          ).as_matrix()
    poses[:, 0, 3] = 0.073 * np.sin(0.12 * t)
    poses[:, 1, 3] = 0.058 * np.cos(0.09 * t)
    poses[:, 2, 3] = 0.8 + 0.087 * np.sin(0.07 * t)
    return poses


def write_orbit_devkit(devkit: str, dev, card: str) -> np.ndarray:
    """Phase 11's 480x640 devkit: LINEMOD intrinsics, "cube" (0.08 m) and
    "sphere" (the 20,480-face icosphere), each class's val_ sequence the
    TRACK_T frames of orbit_poses, each frame's rendered initial pose the
    orbit's perturbed by synth_data.sample_perturbed_pose.  Files as
    tools/synth_data.py writes them (generate_dataset writes the models).
    Returns the orbit."""
    from deepim_tpu_torch.data.pairdb import save_pose_file
    from deepim_tpu_torch.render.rasterizer import rasterize_single
    from deepim_tpu_torch.tools.synth_data import PNG_FILTER, sample_perturbed_pose

    meshes = {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 5)}
    t0 = time.perf_counter()
    generate_dataset(devkit, meshes, LINEMOD_K, n_train=0, n_val=0, height=H, width=W, device=dev)
    orbit = orbit_poses(TRACK_T)
    rng = np.random.RandomState(11)
    k = torch.from_numpy(LINEMOD_K).to(dev)
    for ci, cls in enumerate(sorted(meshes), start=1):
        mesh = meshes[cls]
        bank = MeshBank.from_meshes([mesh]).arrays()
        raster = tune_raster_for_bank(EngineConfig(raster=RasterConfig(height=H, width=W)), bank, LINEMOD_K).raster
        args = [torch.from_numpy(np.asarray(a)).to(dev) for a in (mesh.vertices, mesh.colors, mesh.faces)]
        valid = torch.ones(mesh.num_faces, dtype=torch.bool, device=dev)
        lines = []
        for i, pose in enumerate(orbit):
            idx = f"{i:06d}"
            for sub, p, label in (("observed", pose, True), ("gt_observed", pose, False),
                                  ("rendered", sample_perturbed_pose(pose, rng), False)):
                d = os.path.join(devkit, "data", sub, cls)
                os.makedirs(d, exist_ok=True)
                name = f"{idx}_0" if sub == "rendered" else idx
                rgb, depth = rasterize_single(*args, valid, torch.from_numpy(p).to(dev), k, raster, device=dev)
                depth = depth.cpu().numpy()
                write_png(os.path.join(d, f"{name}-color.png"), rgb.cpu().numpy().astype(np.uint8), PNG_FILTER)
                write_png(os.path.join(d, f"{name}-depth.png"), (depth * 1000.0).astype(np.uint16), PNG_FILTER)
                if label:
                    write_png(os.path.join(d, f"{name}-label.png"), (depth > 0).astype(np.uint8) * ci, PNG_FILTER)
                else:
                    save_pose_file(os.path.join(d, f"{name}-pose.txt"), p)
            lines.append(f"{cls}/{idx} {cls}/{idx}_0")
        with open(os.path.join(devkit, "image_set", f"val_{cls}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    log(f"[tracking] devkit: 2 classes x a {TRACK_T}-frame orbit at {H}x{W} (z {orbit[:, 2, 3].min():.3f}-"
        f"{orbit[:, 2, 3].max():.3f} m), written in {time.perf_counter() - t0:.2f} s [{card}]")
    return orbit


def _yaml_lines(d: dict, indent: str = "") -> list:
    """A config dict as the port's YAML reader reads it (flow lists,
    quoted strings, floats without exponents)."""
    def scalar(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return json.dumps(v)
        if isinstance(v, float):
            return np.format_float_positional(v, trim="-")
        return str(v)

    lines = []
    for key, v in d.items():
        if isinstance(v, dict):
            lines += [f"{indent}{key}:"] + _yaml_lines(v, indent + "  ")
        elif isinstance(v, (list, tuple)):
            lines.append(f"{indent}{key}: [{', '.join(scalar(x) for x in v)}]")
        else:
            lines.append(f"{indent}{key}: {scalar(v)}")
    return lines


def track_config_file(devkit: str, cls: str) -> str:
    """lm6d_ape_iter4_8epoch.yaml pointed at the phase-11 devkit, with the
    one class `cls` (so the bank holds its mesh alone: the cube renders
    through tile_raster, the sphere through csr_raster), written as YAML."""
    from deepim_tpu_torch.utils.yaml_subset import load_file

    d = load_file(EVAL_CFG)
    d["output_path"] = os.path.join(PHASE11_DIR, "output")
    d["SCALES"] = [H, W]
    d["dataset"].update(dataset_path=devkit, root_path=devkit, model_dir=os.path.join(devkit, "models"),
                        class_name=[cls], NUM_CLASSES=1, test_image_set="val_",
                        INTRINSIC_MATRIX=LINEMOD_K.flatten().tolist())
    path = os.path.join(PHASE11_DIR, f"track_{cls}.yaml")
    with open(path, "w") as f:
        f.write("\n".join(_yaml_lines(d)) + "\n")
    validate_config(load_config(path))
    return path


class CentroidOracle:
    """tests/test_tracker.py's analytic stand-in for the network, on the
    port's NCHW input: the untangled delta from the foreground centroid
    shift (vx, vy) and area ratio (vz) of the zoomed (observed, rendered)
    pair, at LINEMOD's focal lengths."""

    num_regressors = 1

    def __init__(self, gain: float = 0.8):
        self.gain, self.fx, self.fy = gain, float(LINEMOD_K[0, 0]), float(LINEMOD_K[1, 1])

    def __call__(self, x):
        fo = (x[:, 0:3].float().sum(1) > 0.02).float()
        fr = (x[:, 3:6].float().sum(1) > 0.02).float()
        h, w = fo.shape[1:]
        ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
        area_o = fo.sum((1, 2)).clamp(min=1.0)
        area_r = fr.sum((1, 2)).clamp(min=1.0)
        vx = self.gain * ((fo * xs).sum((1, 2)) / area_o - (fr * xs).sum((1, 2)) / area_r) / self.fx
        vy = self.gain * ((fo * ys).sum((1, 2)) / area_o - (fr * ys).sum((1, 2)) / area_r) / self.fy
        vz = self.gain * 0.5 * torch.log(area_o / area_r)
        rot = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=x.device).repeat(x.shape[0], 1)
        return {"rot": rot, "trans": torch.stack([vx, vy, vz], -1)}


def frame_errors(a, b) -> np.ndarray:
    """Per-frame max abs difference of two (T, ...) tracks."""
    return np.abs(np.asarray(a) - np.asarray(b)).reshape(len(a), -1).max(1)


def first_departure(err: np.ndarray, tol: float):
    """The first frame whose error exceeds tol, or None."""
    over = np.nonzero(err > tol)[0]
    return int(over[0]) if over.size else None


def small_track_check(dev) -> None:
    """Phase 11a: track_pairdb_sequence on a 64x64 devkit (a cube and an
    80-face icosphere, SMALL_TRACK_T frames of the sphere, TRACK_ITERS
    iterations a frame, the full network) on the card and on the CPU with
    the same weights: fp32 poses to SMALL_TRACK_TOL up to the first
    departure, then as ROUNDING_NUDGE's comment says; bf16 within
    BF16_GAP_FACTOR times the CPU's own bf16-vs-fp32 gap."""
    from deepim_tpu_torch.tools.track_video import track_pairdb_sequence

    devkit = os.path.join(PHASE11_DIR, "devkit64")
    generate_dataset(devkit, {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 1)}, K64,
                     n_train=0, n_val=SMALL_TRACK_T, height=64, width=64, z_range=(0.45, 0.6),
                     raster_cfg=RasterConfig(height=64, width=64, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                             chunk=16, znear=0.05, zfar=10.0), device="cpu")
    cfg = update_config_dict(Config(), {
        "SCALES": [64, 64],
        "dataset": {"dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": ["cube", "sphere"], "INTRINSIC_MATRIX": K64.flatten().tolist(),
                    "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0},
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True, "PIXEL_MEANS": list(PIXEL_MEANS)},
    })
    db, pairdb = load_gt_pairdb(cfg, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit)
    nudged = [dict(pairdb[0], pose_rendered=pairdb[0]["pose_rendered"].copy())] + pairdb[1:]
    nudged[0]["pose_rendered"][:, 3] += ROUNDING_NUDGE
    bank = build_mesh_bank(cfg)
    poses = {}
    for mode in ("fp32", "bf16"):
        model = make_model(True, 12, "cpu", hw=(64, 64), dtype=PRECISIONS[mode][0])
        for side, d in (("cpu", "cpu"), ("cuda", dev)):
            with driver_precision(mode), torch.no_grad():
                poses[mode, side], _, _, run = track_pairdb_sequence(cfg, model.to(d), db, pairdb, bank, TRACK_ITERS,
                                                                     device=d)
            if run["raster_dropped"] or run["frames"] != SMALL_TRACK_T:
                raise AssertionError(f"64x64 track {mode} {side}: {run}")
    err = frame_errors(poses["fp32", "cuda"], poses["fp32", "cpu"])
    dep = first_departure(err, SMALL_TRACK_TOL)
    note = f"every frame within {SMALL_TRACK_TOL}"
    if dep is not None:
        with driver_precision("fp32"), torch.no_grad():
            model = make_model(True, 12, "cpu", hw=(64, 64))
            far = track_pairdb_sequence(cfg, model, db, nudged, bank, TRACK_ITERS, device="cpu")[0]
        gap = frame_errors(far, poses["fp32", "cpu"])
        cpu_dep = first_departure(gap, SMALL_TRACK_TOL)
        note = (f"the card departs from {SMALL_TRACK_TOL} at frame {dep}, the CPU from itself under a "
                f"{ROUNDING_NUDGE} m nudge at {cpu_dep}")
        if cpu_dep is None or dep < cpu_dep or err[cpu_dep:].max() > 2 * gap[cpu_dep:].max():
            raise AssertionError(f"64x64 track: {note}; card vs CPU pose err {err.max()}, the CPU's own gap "
                                 f"{gap.max()}")
        note += f", err {err[cpu_dep:].max():.3g} against twice the CPU's own gap {2 * gap[cpu_dep:].max():.3g}"
    if not np.isfinite(poses["fp32", "cuda"]).all():
        raise AssertionError("64x64 track: non-finite poses on the card")
    ratio = gap_ratio(poses["bf16", "cuda"], poses["bf16", "cpu"], poses["fp32", "cpu"])
    if not np.isfinite(poses["bf16", "cuda"]).all() or ratio > BF16_GAP_FACTOR:
        raise AssertionError(f"64x64 track bf16: card vs CPU pose diff {ratio} of the CPU's bf16-vs-fp32 gap")
    log(f"[reference] 64x64 track (track_pairdb_sequence, {SMALL_TRACK_T} frames x {TRACK_ITERS} iterations, full "
        f"network): fp32 card vs CPU pose err {err.max():.3g} ({note}); bf16 card vs CPU pose diff {ratio:.3g} of "
        f"the CPU's bf16-vs-fp32 gap (limit {BF16_GAP_FACTOR})")


def host_syncs(fn) -> dict:
    """The host synchronisations fn() makes, by source line
    (torch.cuda.set_sync_debug_mode's warnings)."""
    import warnings

    counts = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            counts[where] = counts.get(where, 0) + 1
    return counts


def drive_tracking(dev, card: str) -> dict:
    """Phase 11b and 11c (see the module docstring).  Returns, for each
    class, its kernel's check at the track's render (check_kernel) with the
    track's launches."""
    from deepim_tpu_torch.data.loader import TestLoader
    from deepim_tpu_torch.engine.tracker import make_tracker
    from deepim_tpu_torch.tools import track_video
    from deepim_tpu_torch.utils.avi import read_avi_index

    devkit = os.path.join(PHASE11_DIR, "devkit")
    orbit = write_orbit_devkit(devkit, dev, card)
    checks = {}
    for cls, kernel in (("sphere", "csr_raster"), ("cube", "tile_raster")):
        label = f"tracking {cls}"
        cfg_file = track_config_file(devkit, cls)
        cfg = load_config(cfg_file)
        prefix = os.path.join(PHASE11_DIR, "ckpt", cls, cfg.TRAIN.model_prefix)
        model = make_model(True, 13, dev, hw=(H, W), dtype=torch.bfloat16)
        save_checkpoint(prefix, cfg.TEST.test_epoch, TrainState(model, None))
        bank = build_mesh_bank(cfg)
        ecfg = EngineConfig.from_config(cfg, bank_arrays=bank, device=dev)
        m = MeshBuffers.gather(bank, [0], device=dev)
        plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(orbit[:1]),
                             torch.from_numpy(LINEMOD_K), ecfg.raster, corners=m.corners,
                             corner_colors=m.corner_colors, device=dev)
        if {n for n, _ in plan} != {kernel}:
            raise AssertionError(f"{label}: a render plans {[n for n, _ in plan]}, want {kernel}")
        checks[cls] = check_kernel(kernel, plan[0][1], card, shape=label)
        del checks[cls]["out"]
        # One TRACK_PROFILE_T-frame track under the profiler (breakdown runs
        # it once first: the warm-up track), and the host synchronisations
        # of a 2-frame track under torch's sync debug mode.
        batches = list(TestLoader(load_gt_pairdb(cfg, "LM6D_REFINE", f"val_{cls}", cls, devkit, devkit)[1]
                                  [:TRACK_PROFILE_T], cfg, batch_size=1).batches())
        frames = torch.from_numpy(np.stack([b["image_observed"] for b, _ in batches])).to(dev)
        pose0 = torch.from_numpy(batches[0][0]["pose_rendered"]).to(dev)
        k = torch.from_numpy(LINEMOD_K).to(dev)
        track = make_tracker(model, ecfg, TRACK_ITERS, with_stats=True, device=dev)
        with torch.no_grad():
            fam = breakdown(f"{label} {TRACK_PROFILE_T} frames", lambda: track(frames, m, k, pose0), card)
            syncs = host_syncs(lambda: track(frames[:2], m, k, pose0))
        if any(where.startswith("deepim_tpu_torch/engine/tracker.py") for where in syncs):
            raise AssertionError(f"{label}: the tracker's own code synchronised the host: {syncs}")
        log(f"[{label}] one {TRACK_PROFILE_T}-frame track: device busy {fam['busy']:.2f} of {fam['wall']:.2f} ms "
            f"wall, idle share {1 - fam['busy'] / fam['wall']:.3f}, {fam['wall'] / TRACK_PROFILE_T:.2f} ms a frame "
            f"under the profiler; host synchronisations in a 2-frame track ({2 * TRACK_ITERS} iterations): "
            f"{sum(syncs.values())}, none from engine/tracker.py ({syncs}) [{card}]")

        argv = ["--cfg", cfg_file, "--cls", cls, "--ckpt-prefix", prefix, "--iters-per-frame", str(TRACK_ITERS),
                "--device", str(dev)]
        out = os.path.join(PHASE11_DIR, f"{cls}.avi")
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        res = track_video.main(argv + ["--out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expect = len(plan) * TRACK_T * (TRACK_ITERS + 1)
        if counts != {**{n: 0 for n in counts}, kernel: expect}:
            raise AssertionError(f"{label}: launches {counts}, want {kernel} {expect} ({len(plan)} a render x "
                                 f"{TRACK_T} frames x ({TRACK_ITERS} iterations + the overlay)) and nothing else")
        checks[cls]["launches"] = counts[kernel]
        poses, run = res["poses"], res["run"]
        r = poses[:, :, :3]
        orth = float(np.abs(r @ np.swapaxes(r, -1, -2) - np.eye(3)).max())
        if poses.shape != (TRACK_T, 3, 4) or not np.isfinite(poses).all() or orth > 1e-4 or run["raster_dropped"]:
            raise AssertionError(f"{label}: poses {poses.shape}, finite {np.isfinite(poses).all()}, orthonormality "
                                 f"err {orth}, dropped {run['raster_dropped']}")
        idx = read_avi_index(out)
        if (idx["frames"], idx["height"], idx["width"], idx["fourcc"]) != (TRACK_T, H, W, "MPNG"):
            raise AssertionError(f"{label}: {out} holds {idx['frames']} frames of {idx['height']}x{idx['width']}")
        log(f"[{label}] track_video.main at {H}x{W}, {TRACK_T} frames x {TRACK_ITERS} iterations, bf16 network from "
            f"a checkpoint: {TRACK_T / run['track_s']:.2f} tracked frames/s, {run['track_s'] / TRACK_T * 1e3:.2f} ms a "
            f"frame (the track alone: staging the video on the card, the frame loop, the poses back); decode "
            f"{run['decode_s']:.3f} s; overlay (render, edges) and write {run['overlay_s']:.3f} s ({idx['frames']} "
            f"frames, {run['video']['bytes'] / 2**20:.1f} MiB); the call {wall:.3f} s; launches {counts} (planned {len(plan)} a render); 0 dropped pairs; mean error rot "
            f"{res['rot_err'].mean():.2f} deg, trans {res['trans_err'].mean() * 1e3:.1f} mm (random weights) [{card}]")

        if cls == "sphere":
            # 11c: the loop closes with the centroid oracle in place of the
            # network.  The oracle reads raw intensities (its foreground is
            # luminance > 0.02), so the images are not mean-subtracted.
            oracle_ecfg = dataclasses.replace(ecfg, pixel_means=(0.0, 0.0, 0.0))
            with torch.no_grad():
                _, tracked = make_tracker(CentroidOracle(), oracle_ecfg, TRACK_ITERS, device=dev)(
                    torch.from_numpy(np.stack([b["image_observed"] for b, _ in TestLoader(
                        load_gt_pairdb(cfg, "LM6D_REFINE", "val_sphere", "sphere", devkit, devkit)[1], cfg,
                        batch_size=1).batches()])), m, k, torch.from_numpy(orbit[:1]))
            err = np.linalg.norm(tracked[:, 0, :, 3].cpu().numpy() - orbit[:, :, 3], axis=-1)
            static = np.linalg.norm(orbit[0, :, 3] - orbit[:, :, 3], axis=-1)
            if not err[10:].mean() < 0.5 * static[10:].mean():
                raise AssertionError(f"tracking oracle: mean error after frame 10 {err[10:].mean()} m, static init "
                                     f"{static[10:].mean()} m")
            q = np.quantile(err, [0.0, 0.5, 0.9, 1.0]) * 1e3
            log(f"[tracking oracle] the sphere's {TRACK_T}-frame orbit tracked by the centroid oracle from frame 0's "
                f"gt pose: mean error after frame 10 {err[10:].mean() * 1e3:.2f} mm against "
                f"{static[10:].mean() * 1e3:.2f} mm for the static init; per-frame error quantiles (min, median, 0.9, "
                f"max) "
                f"{', '.join(f'{v:.2f}' for v in q)} mm [{card}]")
    return checks


def drive_vis_video(dev, card: str) -> dict:
    """Phase 11d: TEST.VIS_VIDEO through test_deepim on phase 8's devkit and
    output directory (pred_eval served from its results_pose.pkl).
    Returns csr_raster's check at each video's render (batch VIDEO_PAIRS),
    by class, and the videos' launches."""
    from deepim_tpu_torch.utils.avi import read_avi_index

    devkit = os.path.join(PHASE8_DIR, "devkit")
    cfg = update_config_dict(eval_config(devkit, os.path.join(PHASE8_DIR, "output")), {"TEST": {"VIS_VIDEO": True}})
    out = os.path.join(PHASE8_DIR, "output", "timed")
    classes = list(cfg.dataset.class_name)
    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, bank_arrays=bank, device=dev)
    label = "vis video"
    # Each video's first render (its class, batch VIDEO_PAIRS): its plan and
    # csr_raster held against its twin there.
    checks, expect = {}, 0
    for cls in classes:
        _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", f"val_{cls}", cls, devkit, devkit)
        m = MeshBuffers.gather(bank, np.full(VIDEO_PAIRS, classes.index(cls)), device=dev)
        plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                             torch.from_numpy(np.stack([r["pose_rendered"] for r in recs[:VIDEO_PAIRS]])),
                             torch.from_numpy(cfg.dataset.intrinsic_matrix()), ecfg.raster, corners=m.corners,
                             corner_colors=m.corner_colors, device=dev)
        if {name for name, _ in plan} != {"csr_raster"}:
            raise AssertionError(f"{label} {cls}: a render plans {[name for name, _ in plan]}")
        checks[cls] = check_kernel("csr_raster", plan[0][1], card, shape=f"{label} {cls}")
        del checks[cls]["out"]
        expect += len(plan) * cfg.TEST.test_iter
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    res = test_deepim(cfg, output_dir=out, batch_size=EVAL_B, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if "run" in res or counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"{label}: refined again ({'run' in res}) or launches {counts}, want csr_raster "
                             f"{expect} (each video's plan x {cfg.TEST.test_iter} iterations) and nothing else")
    n_frames = VIDEO_PAIRS * cfg.TEST.test_iter
    for cls in classes:
        idx = read_avi_index(os.path.join(out, f"video_{cls}.avi"))
        if (idx["frames"], idx["height"], idx["width"]) != (n_frames, 2 * H, 2 * W):
            raise AssertionError(f"{label}: video_{cls}.avi holds {idx['frames']} frames of "
                                 f"{idx['height']}x{idx['width']}")
        v = res["videos"][cls]
        log(f"[{label}] test_deepim with TEST.VIS_VIDEO, pred_eval from its cache: video_{cls}.avi, {idx['frames']} "
            f"frames of {2 * H}x{2 * W}, in {v['render_s'] + v['compose_s'] + v['write_s']:.3f} s: render "
            f"(refine_step and the copies to the host) {v['render_s']:.3f} s, Canny and compose "
            f"{v['compose_s']:.3f} s, write {v['write_s']:.3f} s of which PNG encode {v['encode_s']:.3f} s [{card}]")
    log(f"[{label}] the call {wall:.3f} s; launches {counts} (planned {expect}) [{card}]")
    return {"launches": counts["csr_raster"], **checks}


# Phase 12: data parallelism over torch.distributed ranks.
PHASE12_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase12")
DP_LAUNCH_TIMEOUT = 600  # seconds for the ranks' launch
DP_SHIFT = 8             # orbit frames between the starts of two videos of the sharded track
DP_COST_STEPS = 4        # timed DDP steps, and steps alone, on each rank (NCCL only)


def dp_world() -> tuple[int, str]:
    """Phase 12's ranks and backend: one rank a card over NCCL on two cards
    or more; on one card two ranks sharing it over gloo, which holds the
    multi-rank logic on the card and gives no scaling figure."""
    cards = torch.cuda.device_count()
    return (cards, "nccl") if cards >= 2 else (2, "gloo")


def dp_train_config(devkit: str, epochs: int, batch_pairs: int = TRAIN_B, real_only: bool = False):
    """Phase 9's recipe and devkit for `epochs` epochs, batch_pairs a
    process (train_net's global batch: batch_pairs x the ranks); with
    real_only, the LM6D_REFINE set alone (half the pairs)."""
    cfg = train_driver_config(devkit, os.path.join(PHASE12_DIR, "output"), end_epoch=epochs,
                              BATCH_PAIRS=batch_pairs)
    if real_only:
        cfg = update_config_dict(cfg, {"dataset": {"dataset": "LM6D_REFINE", "image_set": "train_"}})
    return cfg


def dp_videos(cfg, world: int, dev):
    """World videos of the 20,480-face sphere on phase 11's orbit, video j
    starting DP_SHIFT x j frames into it, each frame-0 pose perturbed as
    synth_data perturbs it: frames (TRACK_T, world, 3, H, W) rendered on
    `dev`, the meshes, k and pose0 (world, 3, 4)."""
    from deepim_tpu_torch.engine.refine import render_at_pose
    from deepim_tpu_torch.tools.synth_data import sample_perturbed_pose

    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, bank_arrays=bank, device=dev)
    sphere = list(cfg.dataset.class_name).index("sphere")
    orbit = orbit_poses(TRACK_T + DP_SHIFT * (world - 1))
    poses = np.stack([orbit[DP_SHIFT * j:DP_SHIFT * j + TRACK_T] for j in range(world)], 1)
    k = torch.from_numpy(LINEMOD_K).to(dev)
    one = MeshBuffers.gather(bank, np.full(TRACK_T, sphere), device=dev)
    frames = torch.stack([render_at_pose(one, torch.from_numpy(poses[:, j]).to(dev), k, ecfg, device=dev)[0]
                          for j in range(world)], 1)
    rng = np.random.RandomState(11)
    pose0 = torch.from_numpy(np.stack([sample_perturbed_pose(poses[0, j], rng) for j in range(world)]).astype(
        np.float32)).to(dev)
    return frames, MeshBuffers.gather(bank, np.full(world, sphere), device=dev), k, pose0, ecfg


def dp_rank_main(spec_file: str) -> int:
    """One rank of phase 12, started by torch.distributed.run: joins the
    group (initialize_distributed with the spec's backend), trains, tracks,
    writes its figures to <PHASE12_DIR>/rank<r>.json and leaves."""
    from deepim_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    with open(spec_file) as f:
        spec = json.load(f)
    if not initialize_distributed(backend=spec["backend"]):
        raise RuntimeError("chip_smoke --dp-rank: no torch.distributed launcher environment")
    try:
        dp_rank(spec)
    finally:
        shutdown_distributed()
    return 0


def dp_rank(spec: dict) -> None:
    """Phase 12 (i) and (ii) on this rank (see drive_dp)."""
    import hashlib

    from deepim_tpu_torch.data.loader import TrainLoader
    from deepim_tpu_torch.engine.tester import bank_on_device
    from deepim_tpu_torch.engine.tracker import track_video_sharded
    from deepim_tpu_torch.parallel import make_mesh, train_step_dp
    from deepim_tpu_torch.tools.train_net import load_pairdbs

    mesh = make_mesh()
    dev = mesh.device
    set_explicit_precision()
    rk.load_library()
    cfg = dp_train_config(spec["devkit"], spec["epochs"], real_only=spec["real_only"])
    init = build_model(cfg, device="cpu").state_dict()
    saves = []
    save = train_net_mod.save_checkpoint
    train_net_mod.save_checkpoint = lambda *a: saves.append(a[1]) or save(*a)
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    mesh.barrier()
    t0 = time.perf_counter()
    state = train_net(cfg, output_dir=spec["train_dir"], device=dev, init_state_dict=init)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_net_mod.save_checkpoint = save
    counts = launch_counts()
    by_device = {name: dict(KERNELS[name].launches_by_device) for name in KERNELS}
    params = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    digest = hashlib.sha256(b"".join(v.numpy().tobytes() for v in params.values())).hexdigest()
    if mesh.rank == 0:
        torch.save(params, os.path.join(PHASE12_DIR, "params.pt"))

    # Host synchronisations of one DDP step and of one step of this rank
    # alone, on a fresh network (a second DDP replica of the trained one
    # would share its parameters' gradient hooks).
    dbs, pairdb = load_pairdbs(cfg)
    bank = build_mesh_bank(cfg)
    loader = TrainLoader(pairdb, cfg, {c: dbs[0].points(c) for c in cfg.dataset.class_name},
                         cfg.TRAIN.BATCH_PAIRS * mesh.size, process_index=mesh.rank, process_count=mesh.size)
    batches = loader.epoch(0)
    batch = next(batches)
    batches.close()
    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=bank, device=dev)
    bank_d = bank_on_device(bank, dev)
    net = build_model(cfg, device=dev).train()
    fresh = TrainState(net, make_optimizer(net.parameters(), cfg.TRAIN, lambda count: cfg.TRAIN.lr))
    step = make_train_step(ecfg, cfg.train_iter, cfg.TRAIN.FLOW_WEIGHT_TYPE, device=dev)
    dp_step = train_step_dp(step, mesh, fresh)
    dp_step(fresh, batch, bank_d)  # warm-up
    syncs_dp = host_syncs(lambda: dp_step(fresh, batch, bank_d))
    syncs_one = host_syncs(lambda: step(fresh, batch, bank_d))
    costs = None
    if spec["backend"] == "nccl":
        costs = dp_step_costs(mesh, fresh, batch, bank_d, step, dp_step)
        # An epoch's rows assembled first, then stepped through without the
        # loader's threads beside the steps: DDP, then this rank alone.
        epoch_rows = list(loader.epoch(1))
        for kind, fn in (("dp_epoch_ms", dp_step), ("alone_epoch_ms", step)):
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for rows in epoch_rows:
                fn(fresh, rows, bank_d)
            torch.cuda.synchronize()
            costs[kind] = (time.perf_counter() - t0) * 1e3 / len(epoch_rows)

    # (ii) The sharded track.
    frames, meshes, k, pose0, tecfg = dp_videos(cfg, mesh.size, dev)
    model = make_model(True, 13, dev, hw=(H, W), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    mesh.barrier()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, poses = track_video_sharded(model, frames, meshes, k, pose0, tecfg, mesh=mesh,
                                       iters_per_frame=TRACK_ITERS)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    if mesh.rank == 0:
        np.save(os.path.join(PHASE12_DIR, "track_poses.npy"), poses.cpu().numpy())
    out = {
        "rank": mesh.rank, "local_rank": int(os.environ["LOCAL_RANK"]), "current_device": torch.cuda.current_device(),
        "device": str(dev), "param_device": str(next(state.model.parameters()).device), "counts": counts,
        "by_device": by_device, "digest": digest, "saves": saves, "train_s": train_s, "step": state.step,
        "epochs": [{key: (v.tolist() if isinstance(v, np.ndarray) else v) for key, v in e.items() if key != "metrics"}
                   for e in state.epochs],
        "metrics": [{key: v.tolist() for key, v in e["metrics"].items()} for e in state.epochs],
        "syncs_dp_step": syncs_dp, "syncs_one_step": syncs_one, "costs": costs, "track_counts": launch_counts(),
        "track_by_device": {name: dict(KERNELS[name].launches_by_device) for name in KERNELS}, "track_s": track_s,
    }
    with open(os.path.join(PHASE12_DIR, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def dp_step_costs(mesh, state, batch, bank_d, step, dp_step) -> dict:
    """What a DDP step pays over one step of this rank alone, every rank at
    once: one all-reduce of a gradient-sized fp32 tensor (the median of 5,
    CUDA events), DP_COST_STEPS DDP steps and as many steps alone in turns
    (host clock, each between barriers), and one DDP step under the
    profiler (breakdown: the collectives' device ms, busy and wall)."""
    import torch.distributed as dist

    grads = torch.ones(sum(p.numel() for p in state.model.parameters()), device=mesh.device)
    ar_ms = []
    for _ in range(6):
        mesh.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(grads)
        end.record()
        end.synchronize()
        ar_ms.append(start.elapsed_time(end))
    times = {"dp": [], "alone": []}
    for kind in ("dp", "alone", "alone", "dp") * (DP_COST_STEPS // 2):
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (dp_step if kind == "dp" else step)(state, batch, bank_d)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
    fam = breakdown(f"dp step rank {mesh.rank}", lambda: dp_step(state, batch, bank_d), card_line())
    return {"allreduce_ms": statistics.median(ar_ms[1:]), "allreduce_bytes": 4 * grads.numel(),
            "dp_ms": times["dp"], "alone_ms": times["alone"], "profile": fam}


def hold_track(label: str, got: np.ndarray, ref: np.ndarray, nudged) -> str:
    """Phase 11's rule for a track against a reference: frame by frame
    within SMALL_TRACK_TOL up to the first departure, which may come no
    earlier than the reference's own from `nudged()` (its track from frame
    0's pose moved by ROUNDING_NUDGE), then within twice that gap.
    Returns what held."""
    err = frame_errors(got, ref)
    dep = first_departure(err, SMALL_TRACK_TOL)
    if dep is None:
        return f"every frame within {SMALL_TRACK_TOL} (max {err.max():.3g})"
    gap = frame_errors(nudged(), ref)
    ref_dep = first_departure(gap, SMALL_TRACK_TOL)
    if ref_dep is None or dep < ref_dep or err[ref_dep:].max() > 2 * gap[ref_dep:].max():
        raise AssertionError(f"{label}: departs at frame {dep}, the reference from itself at {ref_dep}; err "
                             f"{err.max()}, its own gap {gap.max()}")
    return f"departs at frame {dep} (the reference from itself at {ref_dep}), err {err[ref_dep:].max():.3g}"


def drive_dp(dev, card: str) -> dict:
    """Phase 12 (see the module docstring).  Returns csr_raster's check at
    rank 0's first training render with the ranks' launches."""
    from deepim_tpu_torch.data.loader import TrainLoader
    from deepim_tpu_torch.engine.tracker import make_tracker
    from deepim_tpu_torch.tools.train_net import load_pairdbs

    world, backend = dp_world()
    label = f"dp {backend} x{world}"
    shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    os.makedirs(PHASE12_DIR)
    devkit = os.path.join(PHASE9_DIR, "devkit")
    if not os.path.isdir(devkit):
        write_devkit(devkit, TRAIN_PAIRS, TRAIN_VAL_PAIRS, dev, card, label)
    # On gloo (a shared card: correctness only) one epoch of the real set,
    # 8 steps; on NCCL two epochs of both sets, the second timed as phase 9
    # times its epoch 2.
    real_only = backend == "gloo"
    epochs = 1 if real_only else 2
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        text = (res.stdout + res.stderr).strip()
        links = [line.strip() for line in text.splitlines() if line.strip().startswith("Link ")]
        if links:  # one card's links, and how many cards list as many
            text = (f"{text.count('GPU ')} cards; the first: {len(links) // max(text.count('GPU '), 1)} links, "
                    f"{links[0]}")
        log(f"[{label}] {' '.join(cmd)} (exit {res.returncode}): {text[:2000]}")
    cards = torch.cuda.device_count()
    log(f"[{label}] peer access between the cards (torch.cuda.can_device_access_peer): "
        f"{[[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(cards)] for i in range(cards)]}")
    cfg = dp_train_config(devkit, epochs, TRAIN_B * world, real_only)  # one process on the global batch
    classes, n_inner = list(cfg.dataset.class_name), cfg.network.TRAIN_ITER_SIZE
    global_b = cfg.TRAIN.BATCH_PAIRS
    steps = epochs * ((1 if real_only else 2) * len(classes) * TRAIN_PAIRS // global_b)

    # (iii) Rank 0's first render: its plan, and csr_raster held against its twin there.
    dbs, pairdb = load_pairdbs(cfg)
    loader = TrainLoader(pairdb, cfg, {c: dbs[0].points(c) for c in classes}, global_b, process_index=0,
                         process_count=world)
    batches = loader.epoch(0)
    first = next(batches)
    batches.close()
    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=bank)
    m = MeshBuffers.gather(bank, first.class_index, device=dev)
    plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, first.pose_rendered, first.k, ecfg.raster,
                         corners=m.corners, corner_colors=m.corner_colors, device=dev)
    if {name for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"{label}: rank 0's render plans {[name for name, _ in plan]}")
    kernel = check_kernel("csr_raster", plan[0][1], card, shape=f"{label} rank 0's render")
    del kernel["out"]

    spec = {"backend": backend, "devkit": devkit, "epochs": epochs, "real_only": real_only,
            "train_dir": os.path.join(PHASE12_DIR, "train")}
    spec_file = os.path.join(PHASE12_DIR, "spec.json")
    with open(spec_file, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world),
           os.path.join(ROOT, "chip_smoke.py"), "--dp-rank", spec_file]
    rank_log = os.path.join(PHASE12_DIR, "ranks.log")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(rank_log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_LAUNCH_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "killed at the time limit"
    launch_s = time.perf_counter() - t0
    if rc != 0:
        with open(rank_log) as f:
            tail = f.read()[-8000:]
        raise AssertionError(f"{label}: the ranks' launch ended with {rc}:\n{tail}")
    ranks = []
    for r in range(world):
        with open(os.path.join(PHASE12_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # (i) Launches, cards, replicas, checkpoints, losses.
    expect = len(plan) * n_inner * steps
    for r in ranks:
        where = f"{label} rank {r['rank']}"
        card_r = r["local_rank"] % cards
        if (r["current_device"], r["device"], r["param_device"]) != (card_r, f"cuda:{card_r}", f"cuda:{card_r}"):
            raise AssertionError(f"{where}: current device {r['current_device']}, mesh device {r['device']}, "
                                 f"parameters on {r['param_device']}, want card {card_r}")
        if r["counts"] != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0} or \
                r["by_device"]["csr_raster"] != {str(card_r): expect}:
            raise AssertionError(f"{where}: launches {r['counts']} on cards {r['by_device']}, want csr_raster "
                                 f"{expect} ({len(plan)} a render x {n_inner} inner iterations x {steps} steps) "
                                 f"on card {card_r} and nothing else")
        if r["digest"] != ranks[0]["digest"] or r["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"{where}: parameters or metrics differ from rank 0's")
        if r["saves"] != (list(range(1, epochs + 1)) if r["rank"] == 0 else []):
            raise AssertionError(f"{where}: saved checkpoints {r['saves']}")
        if r["step"] != steps * n_inner:
            raise AssertionError(f"{where}: {r['step']} inner iterations, want {steps * n_inner}")
        for e in r["epochs"]:
            if e["nonfinite_losses"] or e["raster_dropped"] or e["samples"] != steps // epochs * global_b:
                raise AssertionError(f"{where}: epoch {e['epoch']}: {e}")
    ckpts = sorted(os.listdir(os.path.join(spec["train_dir"], f"{cfg.TRAIN.model_prefix}_ckpt")))
    if ckpts != [str(e) for e in range(1, epochs + 1)]:
        raise AssertionError(f"{label}: checkpoint directory holds {ckpts}")

    # Against one process training on the same global batch, bf16 (the
    # driver's default) and fp32 (the scale of phase 7's bf16 rule).
    init = build_model(cfg, device="cpu").state_dict()
    ddp = torch.load(os.path.join(PHASE12_DIR, "params.pt"), weights_only=True)
    refs = {}
    for mode in ("bf16", "fp32"):
        with driver_precision(mode):
            st = train_net(cfg, output_dir=os.path.join(PHASE12_DIR, f"one_{mode}"), device=dev,
                           init_state_dict=init)
        refs[mode] = ({k: v.cpu() for k, v in st.model.state_dict().items()}, st.epochs)
    ratio, worst = param_ratio(ddp, refs["bf16"][0], refs["fp32"][0], init)
    losses = {key: [np.asarray([e[key] for e in ranks[0]["metrics"]])] + [
        np.stack([e["metrics"][key] for e in refs[mode][1]]) for mode in ("bf16", "fp32")]
        for key in ("pm_loss", "flow_loss", "mask_loss", "total")}
    loss_ratio = max(gap_ratio(*v) for v in losses.values())
    if ratio > BF16_GAP_FACTOR or loss_ratio > BF16_GAP_FACTOR or \
            not all(np.isfinite(v[0]).all() for v in losses.values()):
        raise AssertionError(f"{label}: DDP vs one process on the global batch: parameters {ratio} ({worst}), "
                             f"losses {loss_ratio} of the bf16-vs-fp32 gap (limit {BF16_GAP_FACTOR})")

    # (ii) The sharded track against world one-process tracks of the same
    # videos, and one process tracking them as one batch.
    frames, meshes, k, pose0, tecfg = dp_videos(cfg, world, dev)
    model = make_model(True, 13, dev, hw=(H, W), dtype=torch.bfloat16)
    sharded = np.load(os.path.join(PHASE12_DIR, "track_poses.npy"))
    notes = []
    with torch.no_grad():
        track = make_tracker(model, tecfg, TRACK_ITERS, device=dev)
        for j in range(world):
            one = track(frames[:, j:j + 1], MeshBuffers(*(None if x is None else x[j:j + 1] for x in meshes)), k,
                        pose0[j:j + 1])[1][:, 0].cpu().numpy()

            def nudged(j=j):
                p = pose0[j:j + 1].clone()
                p[:, :, 3] += ROUNDING_NUDGE
                return track(frames[:, j:j + 1], MeshBuffers(*(None if x is None else x[j:j + 1] for x in meshes)),
                             k, p)[1][:, 0].cpu().numpy()

            notes.append(hold_track(f"{label} video {j}", sharded[:, j], one, nudged))
        track(frames, meshes, k, pose0)  # warm-up at batch world
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = track(frames, meshes, k, pose0)[1]
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
    if not np.isfinite(sharded).all() or sharded.shape != (TRACK_T, world, 3, 4):
        raise AssertionError(f"{label}: sharded track {sharded.shape}, finite {np.isfinite(sharded).all()}")
    track_expect = TRACK_T * TRACK_ITERS
    for r in ranks:
        card_r = str(r["local_rank"] % cards)
        if r["track_counts"] != {"csr_raster": track_expect, "csr_planes_raster": 0, "tile_raster": 0} or \
                r["track_by_device"]["csr_raster"] != {card_r: track_expect}:
            raise AssertionError(f"{label} rank {r['rank']}: track launches {r['track_counts']} on cards "
                                 f"{r['track_by_device']}, want csr_raster {track_expect} on card {card_r}")

    # Figures.
    for r in ranks:
        for e in r["epochs"]:
            log(f"[{label}] rank {r['rank']} epoch {e['epoch']}: {e['samples']} samples (global) in "
                f"{e['loop_s']:.3f} s, {e['samples'] / e['loop_s']:.2f} samples/s; blocked on the loader "
                f"{e['wait_s']:.3f} s, in train steps {e['step_s']:.3f} s; checkpoint {e['checkpoint_s']:.3f} s "
                f"[{card}]")
        log(f"[{label}] rank {r['rank']}: host syncs of one DDP step ({n_inner} inner iterations) "
            f"{sum(r['syncs_dp_step'].values())} ({r['syncs_dp_step']}); of one step of this rank alone "
            f"{sum(r['syncs_one_step'].values())} [{card}]")
    last = ranks[0]["epochs"][-1]
    log(f"[{label}] train_net over {world} ranks ({backend}), global batch {global_b} ({global_b // world} a rank), "
        f"{epochs} epoch(s) of {steps // epochs} steps x {n_inner} inner iterations: launch {launch_s:.1f} s, "
        f"train_net {ranks[0]['train_s']:.3f} s on rank 0; csr_raster {expect} launches on each rank's own card; "
        f"parameters bit-equal over the ranks; checkpoints {ckpts} written by rank 0 alone; every loss finite, 0 "
        f"dropped pairs; against one process on the global batch: parameters {ratio:.3g} ({worst}), losses "
        f"{loss_ratio:.3g} of its bf16-vs-fp32 gap (limit {BF16_GAP_FACTOR}) [{card}]")
    agg = TRACK_T * world / ranks[0]["track_s"]
    log(f"[{label}] track_video_sharded: {world} videos x {TRACK_T} frames x {TRACK_ITERS} iterations, one a rank: "
        f"{ranks[0]['track_s']:.3f} s on rank 0, {agg:.2f} tracked frames/s in all; one process tracking them as "
        f"one batch of {world}: {batched_s:.3f} s, {TRACK_T * world / batched_s:.2f} frames/s; {track_expect} "
        f"csr_raster launches on each rank's own card; each video against its one-process track: "
        f"{'; '.join(notes)} [{card}]")
    if backend == "nccl":
        for r in ranks:
            c = r["costs"]
            gb = c["allreduce_bytes"] / 1e9
            log(f"[{label}] rank {r['rank']}: all_reduce of {gb:.3f} GB (the fp32 gradients) "
                f"{c['allreduce_ms']:.3f} ms, bus {2 * (world - 1) / world * gb / c['allreduce_ms'] * 1e3:.1f} GB/s; "
                f"DDP step {statistics.median(c['dp_ms']):.1f} ms against {statistics.median(c['alone_ms']):.1f} ms "
                f"for this rank's step alone, every rank at once (medians of {c['dp_ms']} and {c['alone_ms']}); "
                f"one DDP step under the profiler: collectives {c['profile']['collectives']:.2f} ms, busy "
                f"{c['profile']['busy']:.2f} of {c['profile']['wall']:.2f} ms; an epoch's rows assembled first: "
                f"{c['dp_epoch_ms']:.1f} ms a DDP step, {c['alone_epoch_ms']:.1f} ms a step alone; in train_net's "
                f"epoch {r['epochs'][-1]['epoch']}: {r['epochs'][-1]['step_s'] / (steps // epochs) * 1e3:.1f} ms "
                f"a step [{card}]")
        # W = 1: phase 9's cell, batch 4 on one card, timed on its second epoch.
        st = train_net(dp_train_config(devkit, 2), output_dir=os.path.join(PHASE12_DIR, "one_card"), device=dev)
        e = st.epochs[-1]
        log(f"[{label}] scaling: epoch {last['epoch']} {last['samples'] / last['loop_s']:.2f} samples/s over "
            f"{world} cards against {e['samples'] / e['loop_s']:.2f} on one (batch {TRAIN_B}, epoch 2): "
            f"{last['samples'] / last['loop_s'] / (e['samples'] / e['loop_s']):.2f}x [{card}]")
    kernel.update(launches=expect, world=world)
    return kernel


ALL_PHASES = set(range(1, 13))
KERNEL_PHASES = set(range(2, 7))  # phase 2's scenes carry phases 3-6: they run together


def parse_phases(text: str) -> set:
    """'12', '2-6,12' or '1-12' -> the phases to run.  Phase 1 (the device
    and the build) always runs; phases 2-6 run together; phase 11 (its
    videos) reads phase 8's cached run."""
    phases = {1}
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        phases.update(range(int(lo), int(hi or lo) + 1))
    if not phases <= ALL_PHASES:
        raise SystemExit(f"chip_smoke: phases {sorted(phases - ALL_PHASES)} do not exist")
    if phases & KERNEL_PHASES and not KERNEL_PHASES <= phases:
        raise SystemExit("chip_smoke: phases 2-6 run together")
    if 11 in phases and 8 not in phases:
        raise SystemExit("chip_smoke: phase 11 needs phase 8")
    return phases


def main(argv: list | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of deepim_tpu_torch")
    ap.add_argument("--phases", default="1-12", help="phases to run, e.g. 12 or 2-6,12 (default all; phase 1 "
                    "always runs, 2-6 run together, 11 needs 8)")
    ap.add_argument("--dp-rank", metavar="SPEC", help=argparse.SUPPRESS)  # one rank of phase 12
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
              file=sys.stderr)
        return 1
    if args.dp_rank:
        return dp_rank_main(args.dp_rank)
    phases = parse_phases(args.phases)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Device and build.
    card = card_line()
    log(card)
    set_explicit_precision()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}, device "
        f"{torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()}); set_explicit_precision: "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}; phases {sorted(phases)}")
    t0 = time.perf_counter()
    rk.load_library()
    log(f"[build] raster.cu: {time.perf_counter() - t0:.2f} s (nvcc {rk.BUILD_INFO['seconds']:.2f} s) [{card}]")
    for line in rk.BUILD_INFO["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    results = {}
    if 2 in phases:
        # 2. Kernels against their plain twins at their paths' shapes.
        k = torch.from_numpy(LINEMOD_K)
        csr_scene = build_scene(16, H, W, LINEMOD_K, num_iters=4, mesh_detail=5, active_tiles=32, device=dev)
        dense_scene = build_scene(2, H, W, LINEMOD_K, num_iters=4, mesh_detail=2, device=dev)
        train_scene, train_ecfg, batch = train_setup(dev)
        heavy_scene = build_scene(16, H, W, LINEMOD_K, num_iters=4, mesh_detail=3,
                                  max_faces_per_tile=HEAVY_K_CAP, device=dev)
        for name, shape, sc, ecfg in (("csr_raster", "", csr_scene, csr_scene.ecfg),
                                      ("csr_planes_raster", "", train_scene, train_ecfg),
                                      ("tile_raster", "", dense_scene, dense_scene.ecfg),
                                      ("tile_raster", "heavy", heavy_scene, heavy_scene.ecfg)):
            m = sc.meshes
            launches = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0),
                                     k, ecfg.raster, corners=m.corners, corner_colors=m.corner_colors,
                                     device=dev)
            got, args = launches[0]
            if got != name:
                raise AssertionError(f"scene meant for {name} plans {got}")
            if sc is heavy_scene and int(args[2].max()) >= HEAVY_K_CAP:
                raise AssertionError(f"heavy dense scene: a list reached the cap of {HEAVY_K_CAP} faces")
            results[name, shape] = check_kernel(name, args, card, shape=shape)
        heavy = results.pop(("tile_raster", "heavy"))
        results = {name: r for (name, _), r in results.items()}
        # The same training render through csr_raster: the two CSR kernels agree.
        m = train_scene.meshes
        (got, args), = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                                     torch.from_numpy(train_scene.pose0), k, train_scene.ecfg.raster,
                                     corners=m.corners, corner_colors=m.corner_colors, device=dev)
        slots8 = KERNELS[got](*args)
        if got != "csr_raster" or not torch.equal(slots8, results["csr_planes_raster"]["out"]):
            raise AssertionError("csr_planes_raster and csr_raster differ on the training render")
        log(f"[csr_planes_raster] equals csr_raster on the training render (hits, face ids, q, rgb) [{card}]")
        stress_check(card)

        # 3. The eval main path on the CSR kernel in each precision, in turns;
        # 4. the dense kernel; 5. the training path in each precision, in turns.
        csr_models = {m: make_model(False, 0, dev, dtype=PRECISIONS[m][0]) for m in PRECISIONS}
        dense_model = make_model(True, 1, dev)
        eval_runs = {m: [] for m in PRECISIONS}
        train_runs = {m: [] for m in PRECISIONS}
        for mode in TURNS:
            with precision(mode):
                eval_runs[mode].append(drive_main_path(
                    f"main path {mode}, CSR (20,480-face meshes, FAST_TEST)", csr_scene, csr_models[mode], dev,
                    card, "csr_raster", min_per_call=4 * 2, ecfg=with_zoom(csr_scene.ecfg, mode),
                    n_calls=N_TURN_CALLS))
        counts_dense = drive_main_path("main path, dense (320-face meshes, full network)", dense_scene,
                                       dense_model, dev, card, "tile_raster", min_per_call=4)["counts"]
        for mode in TURNS:
            with precision(mode):
                train_runs[mode].append(drive_train(train_scene, train_ecfg, batch, dev, card, mode,
                                                    N_TURN_CALLS))
        for name, runs, unit in (("eval CSR call", eval_runs, "frames_s"),
                                 ("training step", train_runs, "samples_s")):
            log(f"[precision turns] {name}: " + "; ".join(
                f"{m} {[round(r['ms'], 2) for r in rs]} ms, {[round(r[unit], 2) for r in rs]} "
                f"{unit.replace('_', '/')}" for m, rs in runs.items()) + f" (turns {TURNS}) [{card}]")
        results["csr_raster"]["launches"] = eval_runs["bf16"][0]["counts"]["csr_raster"]
        results["tile_raster"]["launches"] = counts_dense["tile_raster"]
        results["csr_planes_raster"]["launches"] = train_runs["bf16"][0]["counts"]["csr_planes_raster"]

        # 6. Where the time goes, in each precision.
        for mode in PRECISIONS:
            with precision(mode):
                for label, fn, train, samples in (
                        ("CSR path", refine_call(csr_scene, csr_models[mode], dev, with_zoom(csr_scene.ecfg, mode)),
                         False, 16 * 4),
                        ("training step", train_runs[mode][-1]["step"], True, TRAIN_B * TRAIN_ITER_SIZE)):
                    fam = breakdown(f"{label} {mode}", fn, card)
                    ops, b_ms = conv_bound_ms(mode, (H, W), 8, train, samples, train)
                    log(f"[{label} {mode} convolutions] {fam['convolutions']:.2f} device ms against a bound of "
                        f"{b_ms:.3f} ms ({ops / 1e12:.2f} TFLOP at {PEAK_OPS_PER_S[mode] / 1e12:.0f} TFLOP/s "
                        f"dense {mode}: {fam['convolutions'] / b_ms:.1f}x); busy {fam['busy']:.2f} of "
                        f"{fam['wall']:.2f} ms [{card}]")
        breakdown("dense path", refine_call(dense_scene, dense_model, dev), card)
        render_comparison(csr_scene, dev, card)

    if phases & {7, 8, 9, 11, 12}:
        for d in (PHASE8_DIR, PHASE9_DIR, PHASE11_DIR):
            shutil.rmtree(d, ignore_errors=True)
    if 7 in phases:
        # 7. Small-input reference checks.
        small_reference_checks(dev)
        small_driver_check(dev)
        small_train_driver_check(dev)

    # 8. The eval driver through its front door; 9. the training driver;
    # 10. the engine's options at full width.
    driver = drive_eval_driver(dev, card) if 8 in phases else None
    trainer = drive_train_driver(dev, card) if 9 in phases else None
    if 10 in phases:
        drive_options(dev, card)

    tracks = videos = None
    if 11 in phases:
        # 11. Tracking and the refinement videos.
        t11 = time.perf_counter()
        small_track_check(dev)
        tracks = drive_tracking(dev, card)
        videos = drive_vis_video(dev, card)
        log(f"[tracking] phase 11 took {time.perf_counter() - t11:.1f} s [{card}]")

    dp = None
    if 12 in phases:
        # 12. Data parallelism: train_net and the sharded track over ranks.
        t12 = time.perf_counter()
        dp = drive_dp(dev, card)
        log(f"[dp] phase 12 took {time.perf_counter() - t12:.1f} s [{card}]")
    log(f"[total] {time.perf_counter() - t_start:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    # The kernels line: each kernel's figures at phase 2's shapes with its
    # launches on its path (phases 3-5), then its figures at each driver's
    # renders as extra keys: tile_raster's heavy shape, csr_raster at the
    # eval and training drivers' renders (phases 8, 9), each kernel at the
    # full-width track's render (phase 11: sphere csr_raster, cube
    # tile_raster) and csr_raster at each refinement video's, and csr_raster
    # at rank 0's render of the data-parallel run (phase 12) with its
    # launches on each rank and the ranks.  Without phase 2, phase 12's
    # figures are csr_raster's own.
    base = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    if dp is not None and "csr_raster" not in results:
        results["csr_raster"] = dict(dp)
    kernels = []
    for name, r in results.items():
        entry = {"name": name, "route": "cuda", "source": "deepim_tpu_torch/csrc/raster.cu",
                 "replaces": REPLACES[name], "launches": r["launches"], **{key: r[key] for key in base},
                 "library_ms": None}
        if name == "tile_raster":
            entry.update({f"heavy_{key}": heavy[key] for key in base})
        for tag, run in (("driver", driver), ("train_driver", trainer)):
            if run is not None and name == "csr_raster":
                entry.update({f"{tag}_{key}": run[key] for key in CHECK_KEYS})
        if tracks is not None and name != "csr_planes_raster":
            entry.update({f"track_{key}": tracks["sphere" if name == "csr_raster" else "cube"][key]
                          for key in CHECK_KEYS})
        if videos is not None and name == "csr_raster":
            entry["video_launches"] = videos["launches"]
            entry.update({f"video_{cls}_{key}": videos[cls][key] for cls in ("cube", "sphere") for key in base})
        if dp is not None and name == "csr_raster":
            entry.update({f"dp_{key}": dp[key] for key in CHECK_KEYS + ("world",)})
        kernels.append(entry)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
