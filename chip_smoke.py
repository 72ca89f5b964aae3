#!/usr/bin/env python3
"""On-card smoke run of deepim_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py               # every phase: one CUDA device, nvcc on PATH or in $CUDA_HOME
    python3 chip_smoke.py --phases 12   # phase 1 (device, build) and phase 12 alone, e.g. on four cards
    python3 chip_smoke.py --phases 13   # phase 1 and phase 13 alone
    python3 chip_smoke.py --phases 14   # phase 1 and phase 14 (the benchmark runners) alone
    python3 chip_smoke.py --phases 15   # phase 1 and phase 15 (the data-preparation toolkit) alone
    python3 chip_smoke.py --phases 16   # phase 1 and phase 16 (the recipe from pretrained weights) alone
    python3 chip_smoke.py --phases 17   # phase 1 and phase 17 (flow2se3, pose metrics, the module tail) alone
    python3 chip_smoke.py --phases 18   # phase 1 and phase 18 (learned tracking, the tracking fine-tune) alone
    python3 chip_smoke.py --phases 19   # phase 1 and phase 19 (A1's seeded 480x640 run, the learning and resume checks)
    python3 chip_smoke.py --phases 20   # phase 1 and phase 20 (the image readers on a devkit and its re-encoded twin)

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
 13. unseen objects, texture sampling and the standalone renderer, under
     deepim_tpu_torch/_build/phase13/: (E) a 2-iteration 64x64 refine with
     lit re-renders and one with texture sampling, card against CPU (fp32
     poses to 1e-4, bf16 within 3x the CPU's own bf16-vs-fp32 gap); (A)
     four "novel" meshes written as OBJs (a 12-face cube, 1,280- and
     20,480-face icospheres, make_mixed_detail_mesh's 20,880 faces) and 64
     seeded poses at LINEMOD depths (write_modelnet_lists), test_deepim on
     the recipe file as a ModelNet_lit evaluation from a seeded checkpoint
     (batch 16, 4 iterations, bf16; a warm-up call, then one timed):
     frames/s and stages, finite per-iteration mean errors, csr_raster and
     nothing else launched exactly (1 observed + 4 refine renders a batch),
     no dropped pair, csr_raster against its twin at a lit render, and the
     host syncs of one lit iteration against the same iteration unlit; (B)
     a devkit of one textured class ("globe": a 16,384-face uv sphere, a
     seeded band-limited 1024x1024 texture, written as textured.obj with
     'vt' lines and texture_map.png; 32 training and 64 test pairs rendered
     by the port), test_deepim with TEXTURE_SAMPLING in turns off, on, on,
     off after a warm-up: frames/s of each, texture_gather's device ms a
     call (torch.profiler) and the per-sample texture copy of
     MeshBuffers.gather, csr_raster against its twin at the uv render and
     its launches exact, the host syncs of one textured iteration against
     the same iteration baked; (C) train_net on that devkit, one epoch of
     8 steps of batch 4 x 4 from seeded weights, with TEXTURE_SAMPLING in
     turns off, on, on, off: samples/s of each, csr_raster launched
     exactly (the recipe's slots8), every loss finite, no dropped pair,
     every parameter moved; csr_raster and csr_planes_raster each against
     its twin at the textured uv render; (D)
     standalone.render of the globe at 480x640, flat and phong, with and
     without the texture, on the card and on the CPU (rgb within 1 level,
     depth 1e-5, hit masks equal), each mode against rgb+depth's parts,
     once at 720x540 (BOP's size, tiles of 16 that do not divide it) and a
     320-face icosphere (tile_raster); launches exact; csr_raster and
     tile_raster each against its twin at a standalone render.
 14. the synthetic accuracy and occlusion benchmarks through their runners'
     main(argv), under deepim_tpu_torch/_build/phase14/: (A)
     tools/benchmark_multiclass at 128x128, 4 classes of
     make_benchmark_classes at subdiv 3 (1,280 faces: tile_raster's dense
     path), 32 training and 8 test pairs a class, 2 epochs of batch 32 x
     TRAIN_ITER_SIZE 2, bf16 (the drivers' default): generation, train_net,
     test_deepim and the init-pose rows; (B) tools/benchmark_occlusion on
     the same classes, 8 training and 8 test scenes, one fine-tune epoch
     from (A)'s checkpoint (viz_visible flow weights), the box_rendered
     eval; (C) both generators at 64x64 (and synth_data's --occlusion front
     door) on the card and on the CPU: every file equal, PNGs after
     decoding.  Checked: tile_raster and no other kernel launched exactly
     the count the code plans (each run's renders: generation, one a
     training step's inner iteration, pred_eval's and eval_flow_epe's one
     an iteration), bit-equal to its twin at (A)'s training render and
     (B)'s eval render; every table value finite, no pair dropped, epoch
     2's mean loss below epoch 1's.  It prints the generation seconds a
     pair, samples/s per epoch, eval frames/s and both tables beside their
     init rows.
 15. the data-preparation toolkit (deepim_tpu_torch/toolkit/), under
     deepim_tpu_torch/_build/phase15/: a BOP-format source at 480x640 with
     LINEMOD intrinsics, rendered by the port (classes "cube", 0.08 m, 12
     faces: tile_raster, and "sphere", the 20,480-face icosphere of radius
     0.05 m as a millimetre PLY: csr_raster; 32 frames a class at 0.5-1.2
     m, masks, scene_gt.json, scene_gt_info.json); (A) every CLI through its
     main(argv) with --device cuda: adapt_devkit rescale-models,
     calc-extents and adapt-images, a 24/8 train/test split,
     gen_gt_observed, gen_rendered_pose (10 a frame), gen_rendered,
     gen_posecnn_rendered (each test frame's gt perturbed as
     sample_rendered_pose perturbs, one frame a class without a detection;
     the cube's as text, the sphere's as per-frame .mat files), syn_poses
     gen-poses (32 a class), gen-observed, gen_rendered_pose and
     gen_rendered on the syn root (1 a frame), check with --vis-dir, and
     stats on train_<cls>; each stage's launches exact (ceil(n / 8) a
     render_many call, twice that in gen-observed) and nothing else, and
     each kernel's unlit and lit launches within BatchRenderer, counted
     apart, equal to the plan;
     exactly the files the JAX pipeline writes, each -meta.mat pose within
     1e-5 of its source, gen_rendered_pose's files byte-equal to a CPU
     run's, check clean, no dropped pair over every sphere pose; (C) each
     kernel against its twin, bit for bit, at its class's first unlit and
     lit toolkit batch; (B) the pipeline through the functions at 64x64
     (K64, a 5,120-face icosphere) on the card and on the CPU: every file
     equal (PNGs after decoding: depth and labels exact, rgb within 1
     level), launches exact; (D) test_deepim with the recipe file on the
     PoseCNN_val_ sets the toolkit wrote (seeded checkpoint, batch 16, 4
     iterations, bf16): csr_raster launched exactly, every table finite.
     It prints each stage's seconds a frame split into render (rasterize up
     to a device synchronize), readback, PNG encode and file writes, the
     PNG bytes a frame, test_deepim's frames/s and the phase's seconds.
 16. the training recipe as written, under deepim_tpu_torch/_build/phase16/
     (its two .params files removed at the end): a 480x640 devkit of the
     20,480-face sphere (8 training pairs, read as LM6D_REFINE and as
     LM6D_REFINE_SYN) with a VOC2012 pool of four JPEGs written by this
     script's baseline encoder (500x375, 500x333 and 375x500; 4:2:0 and
     4:4:4, one with a restart interval), each decoded by utils/jpeg.py on
     the host and held to its source (PSNR); a seeded vanilla-FlowNetS
     flownet-0000.params (6-channel flow_conv1, the encoder, deconv5/4, the
     flow predictors and upsampling_weight, no heads: 36.7 M parameters);
     then train_net on lm6d_ape_iter4_8epoch.yaml as written but for the
     paths, network.pretrained (the file) and REPLACE_OBSERVED_BG_RATIO
     0.5, for one epoch of 4 steps.  Checked: before the first step every
     imported tensor on the card equals the file's array under the mapping
     (flow_conv1 BGR -> RGB and widened with zeros), the heads equal a
     fresh seeded build, and mxnet_from_state_dict of that network read
     back equals the file; every data_syn sample and exactly the real
     samples whose draw fell below the ratio had their background
     replaced; every loss finite, no pair dropped, every parameter
     updated; csr_raster launched exactly as planned and equal to its twin
     at the recipe's render.  It prints init_pretrained's ms, read_jpeg's
     ms a background, s a step and samples/s, whether the native
     mesh/points reader loaded and its parse ms.
 17. the module tail, under deepim_tpu_torch/_build/phase17/: (A) 8
     frames of make_mixed_detail_mesh (20,880 faces) at LINEMOD K, targets
     B at LINEMOD depths, sources A perturbed from them as synth_data
     perturbs; both rendered with render_at_pose (csr_raster launched
     exactly twice, nothing else, and bit-equal to its twin at B's render),
     flow_from_depth on the card, then flow2se3 (numpy PnP-RANSAC) on the
     host a frame on the flow's valid pixels: each recovered transform
     within 0.5 deg and 5 mm of se3_mul(B, se3_inverse(A)); (B) add, adi,
     re, te and arp_2d of 256 seeded pose pairs on the mesh's vertices on
     the card, held to the CPU's float32 run (rtol 1e-5; adi's on the first
     16 pairs) and to the evaluator's float64 host functions (rtol 1e-4; re
     also atol 1e-3 deg); (C) mask_dilate_random of 16 of (A)'s masks on
     the card equal to the CPU's from one seed; (D) the three visibility
     masks of (A)'s depths equal on the card and the CPU; (E)
     visualize_minibatch of (A)'s renders and flow read back as a
     (960, 1920, 3) PNG.  It prints flow2se3's ms a frame, valid points and
     inliers, each metric's card ms against the evaluator's host ms, the
     dilation's ms and the PNG's seconds and bytes.
 18. learned closed-loop tracking at 256x256, under
     deepim_tpu_torch/_build/phase18/: (A) benchmark_multiclass --train-only
     on 4 benchmark classes (1,280 faces: tile_raster), 8 training pairs a
     class, batch 32, 2 epochs at TRAIN_ITER_SIZE 2; (B) track_finetune from
     its epoch-2 checkpoint: the noise-mix devkit (8 training and 16 test
     pairs a class), the seed copy, one epoch; (C) track_learned from the
     fine-tuned checkpoint: 4 videos, 8 frames, 2 iterations a frame after 4
     lock-on iterations, bf16.  Checked: tile_raster launched exactly as
     planned in each and nothing else, and bit-equal to its twin at the
     fine-tune's training render (batch 32) and at the track's render
     (batch 4); every loss finite, no pair dropped, the fine-tune resumed
     at epoch 2; the tracked poses finite and orthonormal, every
     TRACK_JSON number finite.  It prints the TRACK_JSON line, the tracked
     frames a second, one profiled track's idle share and the noise mix's
     initial rotation errors.
 19. A1's chained protocols and the last harnesses, under
     deepim_tpu_torch/_build/phase19/: (A) benchmark_multiclass --train-only
     at 256x256 on 4 benchmark classes, 8 training pairs a class, 1 epoch;
     (B) a 480x640 run seeded from its epoch 1 (--seed-convs): 8 training
     and 4 test pairs a class, batch 16, TRAIN_ITER_SIZE 4, 1 epoch, then
     its test; (C) tools/synthetic_sanity at 128x128, 1 epoch, 32 / 8 pairs
     a class; (D) tools/params_resume_parity (64x64, its defaults) under
     torch.use_deterministic_algorithms.  Checked: tile_raster launched
     exactly as planned in each and nothing else, and bit-equal to its twin
     at the 480x640 run's batch-16 training and test renders; every tensor
     train_net was seeded with equal to the base checkpoint's bit for bit
     but fc6's weight, which equals the fresh draw; every loss finite, no
     pair dropped, the tables finite; the two continued runs of (D) equal
     bit for bit and moved from the seed (an op of the path without a
     deterministic CUDA implementation raises, naming itself).
 20. the image readers (utils/imread.py: PNG and JPEG by content, as
     cv2.imread reads them) through both drivers, under
     deepim_tpu_torch/_build/phase20/: a 480x640 devkit as phases 8-9
     write it (4 training and 4 test pairs a class) and its twin, the same
     file names re-encoded: observed colour files in turn a baseline JPEG
     in the base and the progressive JPEG of the same coefficients in the
     twin (encode_jpeg, libjpeg's simple progression script), a palette PNG
     where the image has at most 256 colours (else Adam7 RGB), 16-bit RGB
     at v * 257 and Adam7 RGB in the twin; depths 16-bit and labels 8-bit
     gray Adam7, half with a tRNS chunk; a VOC pool of two baseline JPEGs
     in the base and their progressive twins (one with restarts).  Each
     twin file decodes on the host exactly to its base file's array in its
     site's mode; then, for each class alone in its bank (cube:
     tile_raster; sphere: csr_raster), test_deepim (4 pairs, batch 16, a
     seeded full network) and train_net (2 steps of 4 pairs, VOC ratio 0.5,
     one epoch from seeded weights) on both devkits under
     torch.use_deterministic_algorithms.  Checked: the twin's poses, tables,
     every step's losses and the trained parameters equal the base's bit
     for bit; the drivers read colour, depth, label and VOC files through
     imread; the class's kernel launched exactly as planned and nothing
     else, and bit-equal to its twin at the class's test render.  It
     prints imread's ms per image for each encoding.
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
import pickle
import random
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# cuBLAS reads its workspace size once a process, at its first call: phase
# 19's deterministic run needs this setting from the start.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deepim_tpu_torch.config import Config, TrainConfig, TrainIterConfig, load_config  # noqa: E402
from deepim_tpu_torch.config import update_config_dict, validate_config  # noqa: E402
from deepim_tpu_torch.data.modelnet import ModelNetDB, write_modelnet_lists  # noqa: E402
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
from deepim_tpu_torch.engine.refine import EngineConfig, LightParams, MeshBuffers, Observation, refine  # noqa: E402
from deepim_tpu_torch.engine.refine import refine_step, render_at_pose, tune_raster_for_bank  # noqa: E402
from deepim_tpu_torch.engine.tester import bank_on_device, pred_eval  # noqa: E402
from deepim_tpu_torch.engine.scene import LINEMOD_K, build_scene, train_batch  # noqa: E402
from deepim_tpu_torch.models.flownet import _ENCODER, FlowNetDeepIM, conv_out  # noqa: E402
from deepim_tpu_torch.eval import evaluator  # noqa: E402
from deepim_tpu_torch.geometry import pose_metrics  # noqa: E402
from deepim_tpu_torch.geometry.rotations import mat2quat  # noqa: E402
from deepim_tpu_torch.geometry.se3 import se3_inverse, se3_mul  # noqa: E402
from deepim_tpu_torch.ops.flow import flow_from_depth  # noqa: E402
from deepim_tpu_torch.ops.flow2se3 import flow2se3, flow_correspondences, pnp_ransac  # noqa: E402
from deepim_tpu_torch.ops.masks import box_fill, mask_dilate_random  # noqa: E402
from deepim_tpu_torch.render import raster_kernels as rk  # noqa: E402
from deepim_tpu_torch.render.lighting import lit_vertex_colors  # noqa: E402
from deepim_tpu_torch.render.mesh import MeshBank, make_icosphere, make_mixed_detail_mesh, make_test_cube  # noqa: E402
from deepim_tpu_torch.render.mesh import make_uv_sphere, smooth_texture, write_obj, write_textured_obj  # noqa: E402
from deepim_tpu_torch.render.rasterizer import KERNELS, RasterConfig, kernel_inputs, rasterize  # noqa: E402
from deepim_tpu_torch.render.rasterizer import _expand_k, _face_validity, bin_faces_csr  # noqa: E402
from deepim_tpu_torch.render.rasterizer import expand_corners, project_vertices  # noqa: E402
from deepim_tpu_torch.render.rasterizer import texture_gather  # noqa: E402
from deepim_tpu_torch.render.stress import stress_tile_list, stress_work_list  # noqa: E402
from deepim_tpu_torch.toolkit._common import DEFAULT_K as TK_K  # noqa: E402
from deepim_tpu_torch.tools.synth_data import generate_dataset, linemod_refine_poses, linemod_standin_bank  # noqa: E402
from deepim_tpu_torch.tools.synth_data import sample_perturbed_pose  # noqa: E402
from deepim_tpu_torch.tools import test_net as test_net_mod  # noqa: E402
from deepim_tpu_torch.tools import train_net as train_net_mod  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_deepim  # noqa: E402
from deepim_tpu_torch.tools.timing import graph_launch_ms  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model, train_net  # noqa: E402
from deepim_tpu_torch.utils.png import read_png, write_png  # noqa: E402
from deepim_tpu_torch.utils.tb import TBLogger  # noqa: E402
from deepim_tpu_torch.utils.visibility import estimate_visib_mask, estimate_visib_mask_est  # noqa: E402
from deepim_tpu_torch.utils.visibility import estimate_visib_mask_gt  # noqa: E402
from deepim_tpu_torch.utils.visualize import visualize_minibatch  # noqa: E402

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
    "csr_bin": "none: the JAX package bins in XLA (deepim_tpu/render/rasterizer.py bin_faces_csr); on the card "
               "it replaces the port's torch sort of one key per budget slot",
}
# The CSR binning's main-path shapes (name, LINEMOD stand-in bank, batch,
# depth range): lm6d_all's and the ape's refine calls at batch 32, the
# ape's training renders at 16.
BIN_SHAPES = (("lm6d_all", "all", 32, (0.6, 1.1)), ("ape", "ape", 32, (0.6, 1.0)),
              ("ape_train", "ape", 16, (0.6, 1.0)))
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


def bin_inputs(kind: str, batch: int, z_range, dev):
    """(fu, fv, valid, cfg) of a LINEMOD stand-in bank's refinement batch
    at 480x640, as rasterizer._plan forms them, under the budget
    tune_raster_for_bank sizes for the bank."""
    bank = linemod_standin_bank(kind)
    arrs = tuple(bank[key] for key in ("vertices", "colors", "faces", "face_valid"))
    cfg = tune_raster_for_bank(EngineConfig(raster=RasterConfig(height=H, width=W)), arrs, LINEMOD_K).raster
    cls, _, pose0 = linemod_refine_poses(batch, len(arrs[0]), 1, z_range)
    verts, cols, faces, fvalid = (torch.from_numpy(np.ascontiguousarray(a[cls])).to(dev) for a in arrs)
    b, nf, _ = faces.shape
    corners, _ = expand_corners(verts, cols, faces)
    u, v, z = project_vertices(corners.reshape(b, nf * 3, 3), torch.from_numpy(pose0).to(dev),
                               _expand_k(torch.from_numpy(LINEMOD_K).to(dev), b))
    fu, fv, fz = (x.reshape(b, nf, 3) for x in (u, v, z))
    return fu, fv, _face_validity(fu, fv, fz, fvalid, cfg), cfg


def check_csr_bin(card: str, dev) -> dict:
    """The binning kernels (raster_kernels.csr_bin through
    rasterizer.csr_segments) against bin_faces_csr on the same card tensors
    at each BIN_SHAPES shape: offsets, counts and dropped equal, every live
    segment equal element for element.  Times both: `ms` device time a
    render's binning (CUDA graph of 20), `call_ms` one call between events,
    `plain_ms` bin_faces_csr on the card (torch's sort and searchsorted over
    the budget, so also `library_ms`); `bound_ms` the bytes no binning can
    avoid at 3.35 TB/s: the corners and validity read once, the real pairs,
    the tiles' offsets and counts and the dropped counts written once.
    Returns the first shape's figures, every shape's under `<name>_` keys."""
    from torch.profiler import ProfilerActivity, profile

    from deepim_tpu_torch.render.rasterizer import csr_segments

    out = {}
    for name, kind, batch, z_range in BIN_SHAPES:
        fu, fv, valid, cfg = bin_inputs(kind, batch, z_range, dev)
        th, tw = cfg.csr_tile_h, cfg.csr_tile_w
        fn = lambda: csr_segments(fu, fv, valid, cfg, th, tw)  # noqa: E731
        plain = lambda: bin_faces_csr(fu, fv, valid, cfg, th, tw)  # noqa: E731
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        for key, x, y in zip(("offsets", "counts", "dropped"), got[1:], ref[1:]):
            if not torch.equal(x, y):
                raise AssertionError(f"csr_bin {name}: {key} differ in {int((x != y).sum())} entries")
        counts = got[2]
        pairs = int(counts.sum())
        live = torch.arange(got[0].shape[1], device=dev)[None, :] < counts.sum(1, keepdim=True)
        if got[0].shape != ref[0].shape or not torch.equal(got[0][live], ref[0][live]):
            raise AssertionError(f"csr_bin {name}: segments differ")
        if not pairs:
            raise AssertionError(f"csr_bin {name}: no pairs binned")
        ms = graph_launch_ms(fn)
        call_ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        split = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA and "csr_bin_" in ev.name:
                key = ev.name[ev.name.index("csr_bin_"):].split("_kernel")[0]
                split[key] = split.get(key, 0.0) + (ev.time_range.end - ev.time_range.start) / 20 / 1e3
        b, nf, _ = fu.shape
        n_tiles = counts.shape[1]
        nbytes = b * nf * (2 * 3 * 4 + 1) + pairs * 4 + b * n_tiles * 2 * 8 + b * 8
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fig = {"max_abs_err": 0.0, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": "bytes", "kernel_ms": {k: round(v, 4) for k, v in split.items()},
               "real_pairs": pairs, "budget_pairs": b * got[0].shape[1], "max_segment": int(counts.max()),
               "dropped": int(got[3].sum())}
        log(f"[csr_bin {name}] vs bin_faces_csr (batch {b}, {nf} faces, pack {cfg.csr_pack}): offsets, counts, "
            f"dropped ({fig['dropped']}) and {pairs} live pairs equal; {pairs / b:.1f} real pairs a sample against "
            f"a budget of {got[0].shape[1]}, longest segment {fig['max_segment']}; kernels {ms:.4f} ms a render on "
            f"the device ({call_ms:.4f} ms a single call), by kernel {fig['kernel_ms']}; bin_faces_csr "
            f"{plain_ms:.3f} ms; bound {b_ms:.5f} ms ({nbytes} bytes) [{card}]")
        if not out:
            out.update(fig)
        out.update({f"{name}_{key}": val for key, val in fig.items()})
    return out


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
    bin_launches = rk.csr_bin.launches  # the binning kernels, one set a CSR render
    if bin_launches != (rk.BIN_KERNELS * counts[expect] if expect != "tile_raster" else 0):
        raise AssertionError(f"{label}: {bin_launches} binning launches for {counts[expect]} {expect} launches")
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
        f"(min {min(ms):.2f}, max {max(ms):.2f}), {b / mean_s:.2f} frames/s; launches {counts}, "
        f"csr_bin {bin_launches}; orthonormality err {orth:.2g}; min pose delta {min(deltas):.3g} [{card}]")
    return {"counts": counts, "bin_launches": bin_launches, "ms": statistics.median(ms), "frames_s": b / mean_s}


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


# Phase 13: unseen objects (ModelNet), per-fragment texture sampling in both
# drivers and the standalone renderer.
PHASE13_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase13")
MODELNET_POSES = 64   # test pairs of the ModelNet lists: 4 batches of 16
TEX_PAIRS = 64        # test pairs of the textured devkit: 4 batches of 16
TEX_TRAIN_PAIRS = 32  # its training pairs: one epoch of 8 steps at batch 4
TEX_SIZE = 1024       # texture side, pixels
TEX_GRID = (64, 128)  # the uv sphere's latitude x longitude bands: 16,384 faces
TEX_TURNS = (False, True, True, False)  # TEXTURE_SAMPLING of phase 13B's timed runs, in turns
BOP_K = np.array([[572.4114, 0.0, 360.0], [0.0, 573.57043, 270.0], [0.0, 0.0, 1.0]], np.float32)


def modelnet_config(model_file: str, pose_file: str, out_root: str):
    """The recipe file through the port's reader as a ModelNet_lit
    evaluation of the given lists."""
    return validate_config(update_config_dict(load_config(EVAL_CFG), {
        "output_path": out_root,
        "dataset": {"dataset": "ModelNet_lit", "model_file": model_file, "pose_file": pose_file},
    }))


def iteration_syncs(model, meshes, pose, dev, **variants) -> dict:
    """host_syncs of one refine_step for each variant, name -> (obs,
    ecfg), after a warm-up step of each and one counted step that is
    thrown away (the first set_sync_debug_mode of a process counts a
    synchronisation inside torch.cuda itself)."""
    def step(obs, ecfg):
        return lambda: refine_step(model, obs, meshes, pose, ecfg, iter_index=0, device=dev)

    for obs, ecfg in variants.values():
        step(obs, ecfg)()
    torch.cuda.synchronize()
    host_syncs(step(*next(iter(variants.values()))))
    return {name: host_syncs(step(*v)) for name, v in variants.items()}


def drive_modelnet(dev, card: str) -> dict:
    """Phase 13A (see the module docstring).  Returns csr_raster's check at
    a lit render with the timed run's launches."""
    from scipy.spatial.transform import Rotation

    label = "modelnet"
    root = os.path.join(PHASE13_DIR, "modelnet")
    os.makedirs(os.path.join(root, "models"))
    meshes = {"cube": make_test_cube(0.08), "ico3": make_icosphere(0.05, 3), "mixed": make_mixed_detail_mesh(0),
              "ico5": make_icosphere(0.05, 5)}
    paths = []
    for name, mesh in meshes.items():
        paths.append(os.path.join(root, "models", f"{name}.obj"))
        write_obj(paths[-1], mesh)
    rng = np.random.RandomState(13)
    rot = Rotation.random(MODELNET_POSES, random_state=rng).as_matrix().astype(np.float32)
    t = np.stack([rng.uniform(-0.05, 0.05, MODELNET_POSES), rng.uniform(-0.05, 0.05, MODELNET_POSES),
                  rng.uniform(0.5, 0.9, MODELNET_POSES)], 1).astype(np.float32)
    model_file, pose_file = write_modelnet_lists(
        root, paths, [(i % len(paths), np.concatenate([rot[i], t[i][:, None]], 1)) for i in range(MODELNET_POSES)])
    cfg = modelnet_config(model_file, pose_file, os.path.join(root, "output"))
    n_iter = cfg.TEST.test_iter
    k = torch.from_numpy(cfg.dataset.intrinsic_matrix()).to(dev)

    # One lit render as test_modelnet plans it (its first batch at the gt
    # poses): csr_raster against its twin there.
    db = ModelNetDB(model_file, pose_file)
    bank = db.mesh_bank()
    arrays = (bank.vertices, bank.colors, bank.faces, bank.face_valid, bank.normals)
    ecfg = EngineConfig.from_config(cfg, bank_arrays=arrays, device=dev)
    recs = db.sample_records()[:EVAL_B]
    m = MeshBuffers.gather(arrays, [r["model_index"] for r in recs], device=dev)

    def stacked(key):
        return torch.from_numpy(np.stack([r[key] for r in recs])).to(dev)

    light = LightParams(stacked("light_position"), stacked("light_intensity"), stacked("brightness_ratio"))
    pose_gt = stacked("pose_observed")
    lit = lit_vertex_colors(m.vertices, m.normals, m.colors, pose_gt, *light)
    plan = kernel_inputs(m.vertices, lit, m.faces, m.face_valid, pose_gt, k, ecfg.raster, device=dev)
    if {name for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"{label}: a lit render plans {[name for name, _ in plan]}")
    kernel = check_kernel("csr_raster", plan[0][1], card, shape="modelnet lit")
    del kernel["out"]

    model = make_model(True, 3, dev, hw=(H, W))
    runs = {}
    for name in ("warm-up", "timed"):
        out = os.path.join(root, "output", name)
        save_checkpoint(os.path.join(out, cfg.TRAIN.model_prefix), cfg.TEST.test_epoch, TrainState(model, None))
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        res = test_deepim(cfg, output_dir=out, batch_size=EVAL_B, device=dev)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t0, launch_counts())
    res, wall, counts = runs["timed"]
    n_batches = math.ceil(MODELNET_POSES / EVAL_B)
    expect = len(plan) * (1 + n_iter) * n_batches
    if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"{label}: launches {counts}, want csr_raster {expect} ({len(plan)} a render x "
                             f"(1 observed + {n_iter} iterations) x {n_batches} batches) and nothing else")
    run = res["run"]
    if run["pairs"] != MODELNET_POSES or run["raster_dropped"]:
        raise AssertionError(f"{label}: {run}")
    means = [(float(np.mean(it["rot_err"])), float(np.mean(it["trans_err"]))) for it in [res["init"]] + res["iters"]]
    if len(res["iters"]) != n_iter or not np.isfinite(means).all():
        raise AssertionError(f"{label}: per-iteration mean errors {means}")

    # Host syncs of one lit iteration against the same iteration unlit.
    eval_model = test_net_mod._eval_model(cfg, init_from=model).to(dev)
    img, _, mask = render_at_pose(m, pose_gt, k, ecfg, light, device=dev)
    obs = Observation(img, box_fill(mask), None, None, k, light=light)
    pose0 = stacked("pose_rendered")
    syncs = iteration_syncs(eval_model, m, pose0, dev, unlit=(obs._replace(light=None), ecfg), lit=(obs, ecfg))
    lit_syncs, plain_syncs = syncs["lit"], syncs["unlit"]
    breakdown(f"{label} lit refine call, batch {EVAL_B}", lambda: refine(eval_model, obs, m, pose0, ecfg, device=dev),
              card)
    if sum(lit_syncs.values()) > sum(plain_syncs.values()):
        raise AssertionError(f"{label}: a lit iteration syncs {lit_syncs}, an unlit one {plain_syncs}")
    log(f"[{label}] test_deepim on ModelNet_lit: {MODELNET_POSES} pairs of 4 novel meshes "
        f"({', '.join(f'{n} {mm.num_faces} faces' for n, mm in meshes.items())}; bank padded to "
        f"{bank.faces.shape[1]} faces) at {H}x{W}, batch {EVAL_B}, {n_iter} iterations, bf16: "
        f"{run['pairs'] / run['net_s']:.2f} frames/s over test_modelnet's renders and refinement (net "
        f"{run['net_s']:.3f} s; data {run['data_s']:.3f} s, eval {run['eval_s']:.3f} s, model {run['model_s']:.3f} s); "
        f"the call {wall:.3f} s, the warm-up call {runs['warm-up'][1]:.3f} s; launches {counts} (planned "
        f"{len(plan)} a render); dropped pairs 0 [{card}]")
    log(f"[{label}] mean rot / trans error, init then each iteration: "
        + "; ".join(f"{r:.3f} deg / {tt * 1e3:.2f} mm" for r, tt in means)
        + f"; host syncs of one lit iteration {sum(lit_syncs.values())} ({lit_syncs}), of the same iteration "
        f"unlit {sum(plain_syncs.values())} [{card}]")
    kernel["launches"] = counts["csr_raster"]
    return kernel


def textured_config(devkit: str, out_root: str, texture: bool, **train):
    """The recipe file through the port's reader, pointed at the textured
    devkit's one class, dataset.TEXTURE_SAMPLING as given; trained (13C)
    for one epoch of the real set from seeded weights with clipping."""
    return validate_config(update_config_dict(load_config(EVAL_CFG), {
        "output_path": out_root,
        "dataset": {"dataset": "LM6D_REFINE", "image_set": "train_", "dataset_path": devkit, "root_path": devkit,
                    "model_dir": os.path.join(devkit, "models"), "class_name": ["globe"],
                    "test_image_set": "val_", "TEXTURE_SAMPLING": texture},
        "network": {"pretrained": ""},
        "TRAIN": {"end_epoch": 1, "grad_clip": RECIPE_TCFG.grad_clip, **train},
        "TEST": {"test_epoch": 1},
    }))


def write_textured_devkit(devkit: str, dev, card: str):
    """Phase 13B's devkit: one class, "globe", a uv sphere of radius 0.05 m
    at LINEMOD density (TEX_GRID bands, 16,384 faces) with a seeded
    band-limited TEX_SIZE^2 texture, written as textured.obj ('vt' lines)
    and texture_map.png; its pairs rendered by the port (480x640, LINEMOD
    intrinsics; colours baked per vertex, as synth_data renders).  Returns
    the mesh."""
    mesh = make_uv_sphere(0.05, *TEX_GRID, smooth_texture(TEX_SIZE, seed=13))
    raster = tune_raster_for_bank(EngineConfig(raster=RasterConfig(height=H, width=W)),
                                  MeshBank.from_meshes([mesh]).arrays(), LINEMOD_K).raster
    t0 = time.perf_counter()
    generate_dataset(devkit, {"globe": mesh}, LINEMOD_K, n_train=TEX_TRAIN_PAIRS, n_val=TEX_PAIRS, height=H,
                     width=W, raster_cfg=raster, device=dev)
    write_textured_obj(os.path.join(devkit, "models", "globe"), mesh)
    log(f"[textured eval] devkit: 1 class (a {mesh.num_faces}-face uv sphere, a {TEX_SIZE}x{TEX_SIZE} texture) x "
        f"({TEX_TRAIN_PAIRS} training + {TEX_PAIRS} test) pairs at {H}x{W}, written in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    return mesh


def drive_textured_eval(dev, card: str, devkit: str) -> dict:
    """Phase 13B (see the module docstring).  Returns csr_raster's check at
    the uv render with the textured runs' launches."""
    label = "textured eval"
    out_root = os.path.join(PHASE13_DIR, "textured_eval")
    cfgs = {tex: textured_config(devkit, out_root, tex) for tex in (False, True)}
    cfg = cfgs[True]
    n_iter = cfg.TEST.test_iter
    k = torch.from_numpy(cfg.dataset.intrinsic_matrix()).to(dev)
    t0 = time.perf_counter()
    bank = build_mesh_bank(cfg)
    bank_s = time.perf_counter() - t0
    if not isinstance(bank, dict) or bank["textures"].shape != (1, TEX_SIZE, TEX_SIZE, 3):
        raise AssertionError(f"{label}: build_mesh_bank gave {type(bank)}")
    ecfg = EngineConfig.from_config(cfg, bank_arrays=bank, device=dev)
    _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", "val_globe", "globe", devkit, devkit)
    pose0 = torch.from_numpy(np.stack([r["pose_rendered"] for r in recs[:EVAL_B]])).to(dev)
    bank_d = bank_on_device(bank, dev)
    idx = torch.zeros(EVAL_B, dtype=torch.long, device=dev)
    gather_ms = cuda_ms(lambda: MeshBuffers.gather(bank_d, idx, device=dev), reps=5)
    m = MeshBuffers.gather(bank_d, idx, device=dev)
    uvz = torch.cat([m.uv, torch.zeros_like(m.uv[..., :1])], -1)
    plan = kernel_inputs(m.vertices, uvz, m.faces, m.face_valid, pose0, k, ecfg.raster, device=dev)
    if {name for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"{label}: a uv render plans {[name for name, _ in plan]}")
    kernel = check_kernel("csr_raster", plan[0][1], card, shape="textured eval uv")
    del kernel["out"]
    uv_img, depth = rasterize(m.vertices, uvz, m.faces, m.face_valid, pose0, k, ecfg.raster, device=dev)
    gather_args = (m.textures, uv_img[..., 0], uv_img[..., 1])
    tg_ms = breakdown("texture_gather", lambda: texture_gather(*gather_args), card)["busy"]
    tg_call_ms = cuda_ms(lambda: texture_gather(*gather_args), reps=10)

    model = make_model(True, 3, dev, hw=(H, W))
    n_batches = math.ceil(TEX_PAIRS / EVAL_B)
    expect = len(plan) * n_iter * n_batches
    fps = {False: [], True: []}
    for i, tex in enumerate((True,) + TEX_TURNS):
        out = os.path.join(out_root, f"run{i}")
        save_checkpoint(os.path.join(out, cfg.TRAIN.model_prefix), cfg.TEST.test_epoch, TrainState(model, None))
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        res = test_deepim(cfgs[tex], output_dir=out, batch_size=EVAL_B, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        run = res["run"]
        if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
            raise AssertionError(f"{label} (TEXTURE_SAMPLING {tex}): launches {counts}, want csr_raster {expect} "
                                 f"({len(plan)} a render x {n_iter} iterations x {n_batches} batches) and nothing "
                                 "else")
        if run["pairs"] != TEX_PAIRS or run["raster_dropped"]:
            raise AssertionError(f"{label} (TEXTURE_SAMPLING {tex}): {run}")
        check_tables(label, res, ["globe"], n_iter)
        if i:
            fps[tex].append(run["pairs"] / (run["data_s"] + run["net_s"]))

    eval_model = test_net_mod._eval_model(cfg, init_from=model).to(dev)
    img = torch.from_numpy(np.stack([read_png(r["image_observed"]) for r in recs[:EVAL_B]])).to(dev)
    img = img.permute(0, 3, 1, 2).float()
    mask = render_at_pose(m, pose0, k, ecfg, device=dev)[2]
    obs = Observation(img, box_fill(mask), None, None, k)
    syncs = iteration_syncs(eval_model, m, pose0, dev, baked=(obs, dataclasses.replace(ecfg, texture_sampling=False)),
                            textured=(obs, ecfg))
    tex_syncs, baked_syncs = syncs["textured"], syncs["baked"]
    for name, e in (("textured", ecfg), ("baked", dataclasses.replace(ecfg, texture_sampling=False))):
        breakdown(f"{label} {name} refine call, batch {EVAL_B}", lambda: refine(eval_model, obs, m, pose0, e, device=dev),
                  card)
    if sum(tex_syncs.values()) > sum(baked_syncs.values()):
        raise AssertionError(f"{label}: a textured iteration syncs {tex_syncs}, a baked one {baked_syncs}")
    log(f"[{label}] test_deepim, {TEX_PAIRS} pairs of the textured globe at {H}x{W}, batch {EVAL_B}, {n_iter} "
        f"iterations, bf16, in turns {TEX_TURNS}: frames/s over pred_eval's loop with TEXTURE_SAMPLING "
        f"{[round(v, 2) for v in fps[True]]}, baked colours {[round(v, 2) for v in fps[False]]}; launches "
        f"{expect} csr_raster a run and nothing else; dropped pairs 0 [{card}]")
    log(f"[{label}] texture_gather at batch {EVAL_B}, {H}x{W}, {TEX_SIZE}^2 textures: {tg_ms:.4f} device ms a call "
        f"(one call under torch.profiler), {tg_call_ms:.4f} ms a call between CUDA events; MeshBuffers.gather of the "
        f"batch's textures ({EVAL_B * TEX_SIZE * TEX_SIZE * 12 / 1e6:.1f} MB copied) {gather_ms:.4f} ms; "
        f"build_mesh_bank {bank_s:.3f} s; host syncs of one textured iteration {sum(tex_syncs.values())} "
        f"({tex_syncs}), of the same iteration baked {sum(baked_syncs.values())} [{card}]")
    kernel["launches"] = expect
    return kernel


def drive_textured_train(dev, card: str, devkit: str) -> tuple[dict, dict]:
    """Phase 13C (see the module docstring).  Returns csr_raster's check at
    the training render with train_net's launches, and csr_planes_raster's
    at the same render with the planes64 kernel (0 launches on this path)."""
    label = "textured train"
    out = os.path.join(PHASE13_DIR, "textured_train")
    cfg = textured_config(devkit, out, True)
    b, n_inner = cfg.TRAIN.BATCH_PAIRS, cfg.network.TRAIN_ITER_SIZE
    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=bank, device=dev)
    _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", "train_globe", "globe", devkit, devkit)
    m = MeshBuffers.gather(bank, np.zeros(b, np.int64), device=dev)
    uvz = torch.cat([m.uv, torch.zeros_like(m.uv[..., :1])], -1)
    pose = torch.from_numpy(np.stack([r["pose_rendered"] for r in recs[:b]]))
    k = torch.from_numpy(cfg.dataset.intrinsic_matrix())
    checks = {}
    for name, csr_kernel in (("csr_raster", "slots8"), ("csr_planes_raster", "planes64")):
        plan = kernel_inputs(m.vertices, uvz, m.faces, m.face_valid, pose, k,
                             dataclasses.replace(ecfg.raster, csr_kernel=csr_kernel), device=dev)
        if {n for n, _ in plan} != {name}:
            raise AssertionError(f"{label}: a uv render with {csr_kernel} plans {[n for n, _ in plan]}")
        checks[name] = check_kernel(name, plan[0][1], card, shape="textured train uv")
        del checks[name]["out"]
        checks[name]["launches"] = 0
    n_plan = len(plan)

    init = build_model(cfg, device="cpu").state_dict()
    steps = TEX_TRAIN_PAIRS // b
    expect = n_plan * n_inner * steps
    rates = {False: [], True: []}
    for i, tex in enumerate(TEX_TURNS):
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_net(textured_config(devkit, out, tex), output_dir=os.path.join(out, f"run{i}"), device=dev,
                          init_state_dict=init)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
            raise AssertionError(f"{label} (TEXTURE_SAMPLING {tex}): launches {counts}, want csr_raster {expect} "
                                 f"({n_plan} a render x {n_inner} inner iterations x {steps} steps) and nothing else")
        e, = state.epochs
        if e["nonfinite_losses"] or e["raster_dropped"] or state.optimizer.count != steps * n_inner:
            raise AssertionError(f"{label}: {e['nonfinite_losses']} non-finite loss values, {e['raster_dropped']} "
                                 f"dropped pairs, {state.optimizer.count} updates (want {steps * n_inner})")
        params = state.model.state_dict()
        still = [key for key, v in init.items() if torch.equal(v, params[key].cpu())]
        if still or not all(bool(torch.isfinite(v).all()) for v in params.values()):
            raise AssertionError(f"{label}: parameters not moved {still} or not finite")
        rates[tex].append(e["samples"] / e["loop_s"])
        log(f"[{label}] train_net, TEXTURE_SAMPLING {tex}, 1 epoch of {steps} steps x {b} pairs x {n_inner} inner "
            f"iterations at {H}x{W}, bf16: {rates[tex][-1]:.2f} samples/s with the data path ({e['samples']} "
            f"samples in {e['loop_s']:.3f} s; blocked on the loader {e['wait_s']:.3f} s, in train steps "
            f"{e['step_s']:.3f} s); the call {wall:.3f} s; launches {counts} [{card}]")
    log(f"[{label}] samples/s in turns {TEX_TURNS}: with TEXTURE_SAMPLING {[round(v, 2) for v in rates[True]]}, baked "
        f"colours {[round(v, 2) for v in rates[False]]}; csr_raster {expect} launches a run (the recipe's csr_kernel "
        f"is slots8) and nothing else; every loss finite, 0 dropped pairs, every parameter moved [{card}]")
    checks["csr_raster"]["launches"] = expect
    return checks["csr_raster"], checks["csr_planes_raster"]


def drive_standalone(dev, card: str, globe) -> dict:
    """Phase 13D (see the module docstring).  Returns csr_raster's check at
    the textured globe's uv render and tile_raster's at a 320-face
    icosphere's, each with the launches of the card's renders."""
    from scipy.spatial.transform import Rotation

    from deepim_tpu_torch.render import standalone

    label = "standalone"
    r = Rotation.from_euler("xyz", [0.3, -0.5, 0.2]).as_matrix().astype(np.float32)
    t = np.float32([0.01, -0.02, 0.6])
    pose = np.concatenate([r, t[:, None]], 1)
    tex = globe.texture / 255.0
    small = make_icosphere(0.05, 2)

    def both(mesh, size, k, **kw):
        return [standalone.render(mesh, size, k, r, t, device=d, **kw) for d in (dev, "cpu")]

    def compare(what, got, want):
        (rgb_g, d_g), (rgb_c, d_c) = got, want
        c_err = int(np.abs(rgb_g.astype(int) - rgb_c.astype(int)).max())
        d_err = float(np.abs(d_g - d_c).max())
        if not np.array_equal(d_g > 0, d_c > 0) or c_err > 1 or d_err > 1e-5 or not (d_g > 0).sum():
            raise AssertionError(f"{label} {what}: card vs CPU rgb err {c_err}, depth err {d_err}, hit masks "
                                 f"{'equal' if np.array_equal(d_g > 0, d_c > 0) else 'differ'}")
        return f"{what}: rgb err {c_err}, depth err {d_err:.3g}, {int((d_g > 0).sum())} px"

    notes = []
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    for shading in ("flat", "phong"):
        for textured in (False, True):
            got, want = both(globe, (W, H), LINEMOD_K, shading=shading, texture=tex if textured else None)
            notes.append(compare(f"{shading}{' textured' if textured else ''}", got, want))
            for mode, part in (("rgb", got[0]), ("depth", got[1])):
                alone = standalone.render(globe, (W, H), LINEMOD_K, r, t, mode=mode, shading=shading,
                                          texture=tex if textured else None, device=dev)
                if not np.array_equal(alone, part):
                    raise AssertionError(f"{label}: mode {mode!r} differs from rgb+depth's ({shading})")
    got, want = both(globe, (720, 540), BOP_K, texture=tex)
    notes.append(compare("720x540 (BOP) textured", got, want))
    got, want = both(small, (W, H), LINEMOD_K, shading="phong")
    notes.append(compare("320-face icosphere phong", got, want))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    # rgb+depth, rgb and depth for each of the 4 globe cases (a textured
    # phong render is 2 rasterizations), the BOP render; the icosphere's.
    want_counts = {"csr_raster": 3 * 5 + 1, "csr_planes_raster": 0, "tile_raster": 1}
    if counts != want_counts:
        raise AssertionError(f"{label}: launches {counts}, want {want_counts}")

    checks = {}
    for name, mesh in (("csr_raster", globe), ("tile_raster", small)):
        cfg = standalone.raster_config(mesh, (W, H), LINEMOD_K, pose, 0.1, 10.0)
        attrs = torch.from_numpy(np.concatenate([mesh.uv, np.zeros_like(mesh.uv[:, :1])], 1)
                                 if mesh.uv is not None else mesh.colors)
        (got_name, args), = kernel_inputs(torch.from_numpy(mesh.vertices)[None], attrs[None],
                                          torch.from_numpy(mesh.faces)[None],
                                          torch.ones((1, mesh.num_faces), dtype=torch.bool),
                                          torch.from_numpy(pose)[None], torch.from_numpy(LINEMOD_K), cfg, device=dev)
        if got_name != name:
            raise AssertionError(f"{label}: {mesh.num_faces} faces plan {got_name}")
        checks[name] = check_kernel(name, args, card, shape="standalone")
        del checks[name]["out"]
        checks[name]["launches"] = counts[name]
    log(f"[{label}] standalone.render at {H}x{W} (globe, {globe.num_faces} faces) in each shading, with and without "
        f"the texture, each mode; at 720x540; a 320-face icosphere: card vs CPU "
        + "; ".join(notes) + f"; {wall:.3f} s for the card's and the CPU's renders; launches {counts} [{card}]")
    return checks


def small_lit_textured_checks(dev, card: str) -> None:
    """Phase 13E: a 2-iteration 64x64 refine with lit re-renders (ModelNet)
    and one with texture sampling, card against CPU with the same weights:
    fp32 poses to 1e-4, bf16 (network and image zoom) within BF16_GAP_FACTOR
    times the CPU's own bf16-vs-fp32 pose gap."""
    k = torch.from_numpy(K64)
    cube, ico, globe = make_test_cube(0.09), make_icosphere(0.055, 1), make_uv_sphere(0.05, 12, 24,
                                                                                    smooth_texture(64, seed=3))
    lit_bank = MeshBank.from_meshes([cube, ico], pad_multiple=64).with_normals([cube, ico]).arrays()
    tex_bank = MeshBank.from_meshes([globe], pad_multiple=64, keep_textures=True).arrays()
    pose_gt = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    pose_gt[:, :3, :3] = np.array([[[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.eye(3)], np.float32)
    pose_gt[:, 2, 3] = 0.55
    pose0 = pose_gt.copy()
    pose0[:, :, 3] += np.float32([0.01, -0.008, 0.03])
    raster = RasterConfig(height=64, width=64, tile_h=16, tile_w=16, max_faces_per_tile=128, znear=0.05, zfar=10.0)
    for what, bank, cls, kw in (("lit", lit_bank, [0, 1], {}), ("textured", tex_bank, [0, 0],
                                                             {"texture_sampling": True})):
        ecfg = EngineConfig(height=64, width=64, raster=raster, num_iters=2, **kw)
        meshes = MeshBuffers.gather(bank, cls, device="cpu")
        light = (LightParams(torch.tensor([[0.1, -0.2, -0.4], [-0.3, 0.1, -0.5]]), torch.tensor([[1.1, 0.9, 1.0]] * 2),
                             torch.tensor([0.4, 0.2])) if what == "lit" else None)
        img, _, mask = render_at_pose(meshes, torch.from_numpy(pose_gt), k, ecfg, light, device="cpu")
        obs = Observation(img, box_fill(mask), None, None, k, light=light)
        poses = {}
        for mode in ("fp32", "bf16"):
            for side, d in (("cpu", "cpu"), ("cuda", dev)):
                model = make_model(True, 5, d, hw=(64, 64), dtype=PRECISIONS[mode][0])
                poses[mode, side] = refine(model, obs, meshes, torch.from_numpy(pose0), with_zoom(ecfg, mode),
                                           device=d)[1].cpu().numpy()
        err = float(np.abs(poses["fp32", "cuda"] - poses["fp32", "cpu"]).max())
        ratio = gap_ratio(poses["bf16", "cuda"], poses["bf16", "cpu"], poses["fp32", "cpu"])
        if not np.isfinite(poses["bf16", "cuda"]).all() or err > 1e-4 or ratio > BF16_GAP_FACTOR:
            raise AssertionError(f"64x64 {what} refine: card vs CPU fp32 pose err {err}, bf16 {ratio} of the CPU's "
                                 "bf16-vs-fp32 gap")
        log(f"[reference] 64x64 {what} refine, 2 iterations: fp32 card vs CPU pose err {err:.3g}; bf16 card vs CPU "
            f"pose diff {ratio:.3g} of the CPU's bf16-vs-fp32 gap (limit {BF16_GAP_FACTOR}) [{card}]")


def drive_phase13(dev, card: str) -> dict:
    """Phase 13: 13E, then 13A-13D.  Returns each kernel's checks at this
    phase's renders, keyed by kernel and render."""
    shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    small_lit_textured_checks(dev, card)
    out = {"csr_raster": {"modelnet": drive_modelnet(dev, card)}}
    devkit = os.path.join(PHASE13_DIR, "textured_devkit")
    globe = write_textured_devkit(devkit, dev, card)
    out["csr_raster"]["textured_eval"] = drive_textured_eval(dev, card, devkit)
    out["csr_raster"]["textured_train"], planes = drive_textured_train(dev, card, devkit)
    out["csr_planes_raster"] = {"textured_train": planes}
    standalone_checks = drive_standalone(dev, card, globe)
    out["csr_raster"]["standalone"] = standalone_checks["csr_raster"]
    out["tile_raster"] = {"standalone": standalone_checks["tile_raster"]}
    return out


# Phase 14: the synthetic accuracy and occlusion benchmarks through their
# runners (tools/benchmark_multiclass.py, tools/benchmark_occlusion.py), cut
# from the 13-class, 256-pair, 30-epoch protocol to fit about two minutes.
PHASE14_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase14")
BENCH_SIZE = 128      # the 128x128 proxy protocol's frame
BENCH_CLASSES = 4     # of make_benchmark_classes, at subdiv 3: 1,280 faces (tile_raster's dense path)
BENCH_TRAIN, BENCH_VAL = 32, 8   # pairs a class
BENCH_EPOCHS = 2
BENCH_BATCH = 32
BENCH_ITER_SIZE = 2
OCC_SCENES = 8        # occlusion training scenes, and as many test scenes
OCC_ITER_SIZE = 4     # benchmark_occlusion's --train-iter-size default
TEST_ITERS = 4        # both runners' TEST.test_iter
SMALL_GEN = 64        # 14C's frame


def bench_argv(devkit: str) -> tuple[list, list]:
    """The multiclass and occlusion runners' flags of 14A and 14B."""
    common = ["--size", str(BENCH_SIZE), "--classes", str(BENCH_CLASSES), "--subdiv", "3", "--batch",
              str(BENCH_BATCH), "--out", devkit, "--device", "cuda"]
    return (common + ["--n-train", str(BENCH_TRAIN), "--n-val", str(BENCH_VAL), "--epochs", str(BENCH_EPOCHS),
                      "--train-iter-size", str(BENCH_ITER_SIZE)],
            common + ["--epochs", str(BENCH_EPOCHS), "--n-scenes", str(OCC_SCENES), "--train-scenes",
                      str(OCC_SCENES), "--finetune-epochs", "1"])


def bench_render_check(cfg, train: bool, image_set: str, dev, card: str, shape: str, batch: int = BENCH_BATCH) -> dict:
    """tile_raster against its twin, bit for bit, at one render of a run:
    a batch of `batch` initial poses (as many of each class's pairs in
    image_set), the class meshes and the run's raster settings."""
    bank = build_mesh_bank(cfg)
    ecfg = EngineConfig.from_config(cfg, train=train, bank_arrays=bank, device=dev)
    classes = list(cfg.dataset.class_name)
    per = batch // len(classes)
    idx, poses = [], []
    for ci, cls in enumerate(classes):
        _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", image_set + cls, cls, cfg.dataset.root_path,
                                 cfg.dataset.dataset_path)
        idx += [ci] * per
        poses += [r["pose_rendered"] for r in recs[:per]]
    m = MeshBuffers.gather(bank, np.asarray(idx), device=dev)
    plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(np.stack(poses)),
                         torch.from_numpy(cfg.dataset.intrinsic_matrix()), ecfg.raster, corners=m.corners,
                         corner_colors=m.corner_colors, device=dev)
    if [name for name, _ in plan] != ["tile_raster"]:
        raise AssertionError(f"{shape}: a render plans {[name for name, _ in plan]}")
    check = check_kernel("tile_raster", plan[0][1], card, shape=shape)
    if check["max_abs_err"] != 0.0:
        raise AssertionError(f"{shape}: tile_raster differs from its twin by {check['max_abs_err']}")
    del check["out"]
    return check


def run_bench(label: str, main, argv: list, expect: int, pairs: int, card: str) -> dict:
    """One runner's main(argv) with the launch counters zeroed just before
    and read just after: tile_raster `expect` times and nothing else, every
    table value finite, `pairs` tested and none dropped, every epoch's
    losses finite."""
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != {"csr_raster": 0, "csr_planes_raster": 0, "tile_raster": expect}:
        raise AssertionError(f"{label}: launches {counts}, want tile_raster {expect} and nothing else")
    table = out["table"]
    values = list(table["init"].values()) + [v for row in table["iters"] for v in row.values()]
    if len(table["iters"]) != TEST_ITERS or not np.isfinite(values).all():
        raise AssertionError(f"{label}: table {table}")
    run = out["run"]
    if run["raster_dropped"] or run["pairs"] != pairs:
        raise AssertionError(f"{label}: {run['pairs']} pairs tested, {run['raster_dropped']} dropped face-tile pairs")
    for e in out["epochs"]:
        if e["nonfinite_losses"] or e["raster_dropped"]:
            raise AssertionError(f"{label}: epoch {e['epoch']}: {e['nonfinite_losses']} non-finite loss values, "
                                 f"{e['raster_dropped']} dropped face-tile pairs")
    gen = out["generation"]
    n_gen = gen.get("pairs", gen.get("scenes"))
    log(f"[{label}] {wall:.3f} s in all; generation {gen['seconds']:.3f} s for {n_gen} "
        f"{'pairs' if 'pairs' in gen else 'scenes'} ({gen['seconds'] / n_gen:.4f} s each); launches {counts} "
        f"[{card}]")
    for e in out["epochs"]:
        log(f"[{label}] epoch {e['epoch']}: {e['samples'] / e['loop_s']:.2f} samples/s ({e['samples']} samples in "
            f"{e['loop_s']:.3f} s; blocked on the loader {e['wait_s']:.3f} s, in train steps {e['step_s']:.3f} s); "
            f"mean loss {float(e['metrics']['total'].mean()):.4f} [{card}]")
    log(f"[{label}] test_deepim: {run['pairs']} pairs, {run['pairs'] / (run['data_s'] + run['net_s']):.2f} frames/s "
        f"over pred_eval's loop (data {run['data_s']:.3f} s + net {run['net_s']:.3f} s); init "
        f"{json.dumps(table['init'])}; iterations {json.dumps(table['iters'])} [{card}]")
    return out


def generator_check(dev, card: str) -> None:
    """14C: both generators and synth_data's --occlusion front door on the
    card and on the CPU; every file equal (PNGs after decoding)."""
    from deepim_tpu_torch.render.mesh import make_benchmark_classes
    from deepim_tpu_torch.tools import synth_data
    from deepim_tpu_torch.tools.benchmark_multiclass import benchmark_k

    meshes = make_benchmark_classes(2, subdiv=3)
    k = benchmark_k(SMALL_GEN, SMALL_GEN)
    raster = RasterConfig(height=SMALL_GEN, width=SMALL_GEN, znear=0.05, zfar=10.0)
    runs = {
        "single": lambda out, d: synth_data.generate_dataset(out, meshes, k, n_train=2, n_val=2, height=SMALL_GEN,
                                                             width=SMALL_GEN, z_range=(0.45, 0.75),
                                                             raster_cfg=raster, device=d),
        "occlusion": lambda out, d: synth_data.generate_occlusion_dataset(
            out, meshes, k, n_scenes=4, n_train=2, height=SMALL_GEN, width=SMALL_GEN, z_range=(0.55, 0.75),
            lateral_spread=0.1, raster_cfg=raster, device=d),
        "main --occlusion": lambda out, d: synth_data.main(["--out", out, "--occlusion", "--n-train", "0",
                                                            "--n-val", "2", "--device", str(d)]),
    }
    # Renders: 2 classes x 4 pairs x 2; 4 scenes x 2 classes x 2; 2 scenes x 2 classes x 2.
    renders = {"single": 16, "occlusion": 16, "main --occlusion": 8}
    notes = []
    for what, gen in runs.items():
        dirs = {d: os.path.join(PHASE14_DIR, "small", what.replace(" ", "_").replace("-", ""), d)
                for d in ("cuda", "cpu")}
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        t0 = time.perf_counter()
        gen(dirs["cuda"], dev)
        card_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != {"csr_raster": 0, "csr_planes_raster": 0, "tile_raster": renders[what]}:
            raise AssertionError(f"generators {what}: launches {counts}, want tile_raster {renders[what]}")
        gen(dirs["cpu"], "cpu")
        files = sorted(os.path.relpath(os.path.join(r, f), dirs["cpu"])
                       for r, _, fs in os.walk(dirs["cpu"]) for f in fs)
        mine = sorted(os.path.relpath(os.path.join(r, f), dirs["cuda"])
                      for r, _, fs in os.walk(dirs["cuda"]) for f in fs)
        if files != mine:
            raise AssertionError(f"generators {what}: the card wrote {sorted(set(mine) ^ set(files))} apart")
        pngs = 0
        for rel in files:
            a, b = (os.path.join(dirs[d], rel) for d in ("cuda", "cpu"))
            if rel.endswith(".png"):
                same = np.array_equal(read_png(a), read_png(b))
                pngs += 1
            else:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    same = fa.read() == fb.read()
            if not same:
                raise AssertionError(f"generators {what}: {rel} differs between the card and the CPU")
        notes.append(f"{what}: {len(files)} files ({pngs} PNGs) equal, card {card_s:.3f} s")
    log("[generators] 64x64 benchmark classes (and synth_data's 480x640 cube and sphere for main --occlusion), "
        "card vs CPU: " + "; ".join(notes) + f" [{card}]")


def drive_phase14(dev, card: str) -> dict:
    """Phase 14: 14A, 14B, then 14C.  Returns tile_raster's checks at
    14A's training render and at 14B's eval render, each with its run's
    launches."""
    from deepim_tpu_torch.tools import benchmark_multiclass, benchmark_occlusion

    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    devkit = os.path.join(PHASE14_DIR, "bench")
    multiclass_argv, occlusion_argv = bench_argv(devkit)
    c, evals = BENCH_CLASSES, 2 * TEST_ITERS  # pred_eval's refine and eval_flow_epe each render once an iteration
    batches = -(-BENCH_VAL // BENCH_BATCH)
    # 14A: each pair's observed and initial pose rendered once; one render a
    # training step's inner iteration; one batch a class in the eval.
    expect_a = (c * (BENCH_TRAIN + BENCH_VAL) * 2 + BENCH_EPOCHS * (c * BENCH_TRAIN // BENCH_BATCH) * BENCH_ITER_SIZE
                + c * batches * evals)
    bench = run_bench("benchmark_multiclass", benchmark_multiclass.main, multiclass_argv, expect_a, c * BENCH_VAL,
                      card)
    losses = [float(e["metrics"]["total"].mean()) for e in bench["epochs"]]
    if len(losses) != BENCH_EPOCHS or not losses[1] < losses[0]:
        raise AssertionError(f"benchmark_multiclass: mean loss by epoch {losses}: epoch 2 not below epoch 1")
    args = benchmark_multiclass.parse_args(multiclass_argv)
    classes = sorted(benchmark_multiclass.make_benchmark_classes(c, 3))
    cfg = benchmark_multiclass.benchmark_config(args, devkit, classes, benchmark_multiclass.benchmark_k(
        BENCH_SIZE, BENCH_SIZE))
    train_check = bench_render_check(cfg, True, "train_", dev, card, "bench13 train")
    train_check["launches"] = expect_a

    # 14B: each scene renders every class at its gt and initial pose.
    batches = -(-OCC_SCENES // BENCH_BATCH)
    expect_b = (2 * OCC_SCENES * c * 2 + (OCC_SCENES * c // BENCH_BATCH) * OCC_ITER_SIZE + c * batches * evals)
    run_bench("benchmark_occlusion", benchmark_occlusion.main, occlusion_argv, expect_b, c * OCC_SCENES, card)
    occ_args = benchmark_occlusion.parse_args(occlusion_argv)
    occ_cfg = benchmark_occlusion.occlusion_config(occ_args, f"{devkit}_occ{OCC_SCENES}_{OCC_SCENES}", classes,
                                                   benchmark_multiclass.benchmark_k(BENCH_SIZE, BENCH_SIZE))
    eval_check = bench_render_check(occ_cfg, False, "val_", dev, card, "occlusion eval")
    eval_check["launches"] = expect_b

    generator_check(dev, card)
    return {"tile_raster": {"bench_train": train_check, "occ_eval": eval_check}}


# Phase 15: the data-preparation toolkit (deepim_tpu_torch/toolkit/) through
# each module's main(argv), on a BOP-format source written here.
PHASE15_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase15")
TK_CLASSES = ("cube", "sphere")  # toolkit ids 1 and 2 (outside the LINEMOD table), PairDB's sorted order
TK_FRAMES = 32        # BOP frames a class (LINEMOD's test split has ~1,200)
TK_TRAIN = 24         # of them in <cls>_train.txt, the rest in <cls>_test.txt
TK_PER_OBSERVED = 10  # gen_rendered_pose's default
TK_SYN = 32           # syn poses a class (the reference samples 10,000)
TK_SYN_PER_OBSERVED = 1
TK_BATCH = 8          # every toolkit CLI's --batch default
TK_NO_DETECTION = 3   # the test frame of each class given to gen_posecnn_rendered as "no detection"
TK_SMALL = 64         # 15B's frame: K64, 6 frames a class, a 5,120-face icosphere (still csr_raster)
TK_SMALL_FRAMES, TK_SMALL_TRAIN, TK_SMALL_SYN = 6, 4, 8
TK_SEED = 15


def write_ply_mm(path: str, mesh) -> None:
    """An ascii PLY in millimetres with vertex colours (the BOP model format)."""
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {mesh.num_vertices}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                f"element face {mesh.num_faces}\nproperty list uchar int vertex_indices\nend_header\n")
        for v, c in zip(mesh.vertices * 1000.0, mesh.colors):
            f.write(f"{v[0]} {v[1]} {v[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")
        for tri in mesh.faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def write_bop_source(src: str, meshes: dict, frames: int, k: np.ndarray, hw: tuple, dev) -> dict:
    """A BOP-format source under `src`: models/obj_<id>.ply (millimetres)
    and test/<id>/ with rgb, depth (mm) and mask PNGs, scene_gt.json and
    scene_gt_info.json, one instance a frame at a seeded pose at LINEMOD
    depths (0.5-1.2 m), rendered by the port from the PLY it wrote (the
    toolkit's RasterConfig; batches of TK_BATCH).  Returns each class's
    poses."""
    from scipy.spatial.transform import Rotation

    from deepim_tpu_torch.render.mesh import load_ply

    cfg = RasterConfig(height=hw[0], width=hw[1])
    rng = np.random.RandomState(TK_SEED)
    poses_by_cls = {}
    os.makedirs(os.path.join(src, "models"), exist_ok=True)
    for obj, cls in enumerate(TK_CLASSES, start=1):
        ply = os.path.join(src, "models", f"obj_{obj:06d}.ply")
        write_ply_mm(ply, meshes[cls])
        mesh = load_ply(ply, scale=0.001)
        scene = os.path.join(src, "test", f"{obj:06d}")
        for sub in ("rgb", "depth", "mask"):
            os.makedirs(os.path.join(scene, sub), exist_ok=True)
        poses = np.zeros((frames, 3, 4), np.float32)
        for i in range(frames):
            z = rng.uniform(0.5, 1.2)
            poses[i, :, :3] = Rotation.random(random_state=rng).as_matrix()
            poses[i, :, 3] = (rng.uniform(-0.06, 0.06) * z, rng.uniform(-0.05, 0.05) * z, z)
        verts, cols = (torch.from_numpy(np.repeat(a[None], TK_BATCH, 0)).to(dev) for a in (mesh.vertices, mesh.colors))
        faces = torch.from_numpy(np.repeat(mesh.faces[None], TK_BATCH, 0)).to(dev)
        fvalid = torch.ones(faces.shape[:2], dtype=torch.bool, device=dev)
        gt, info = {}, {}
        for start in range(0, frames, TK_BATCH):
            chunk = poses[start:start + TK_BATCH]
            rgb, depth = rasterize(verts[:len(chunk)], cols[:len(chunk)], faces[:len(chunk)], fvalid[:len(chunk)],
                                   torch.from_numpy(chunk), torch.from_numpy(k), cfg, device=dev)
            rgb, depth = rgb.cpu().numpy(), depth.cpu().numpy()
            for j, pose in enumerate(chunk):
                i = start + j
                mask = depth[j] > 0
                ys, xs = np.nonzero(mask)
                write_png(os.path.join(scene, "rgb", f"{i:06d}.png"), np.clip(rgb[j], 0, 255).astype(np.uint8), 1)
                write_png(os.path.join(scene, "depth", f"{i:06d}.png"), (depth[j] * 1000.0).astype(np.uint16), 1)
                write_png(os.path.join(scene, "mask", f"{i:06d}_000000.png"), mask.astype(np.uint8) * 255, 1)
                gt[str(i)] = [{"obj_id": obj, "cam_R_m2c": pose[:, :3].flatten().tolist(),
                               "cam_t_m2c": (pose[:, 3] * 1000.0).tolist()}]
                info[str(i)] = [{"bbox_visib": [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1,
                                                int(np.ptp(ys)) + 1]}]
        for name, d in (("scene_gt.json", gt), ("scene_gt_info.json", info)):
            with open(os.path.join(scene, name), "w") as f:
                json.dump(d, f)
        poses_by_cls[cls] = poses
    return poses_by_cls


def write_splits(root: str, train: int) -> None:
    """<cls>_train.txt (the first `train` frames of <cls>_all.txt, which
    adapt-images wrote) and <cls>_test.txt (the rest)."""
    obs = os.path.join(root, "image_set", "observed")
    for cls in TK_CLASSES:
        with open(os.path.join(obs, f"{cls}_all.txt")) as f:
            indices = [x.strip() for x in f if x.strip()]
        for name, sel in (("train", indices[:train]), ("test", indices[train:])):
            with open(os.path.join(obs, f"{cls}_{name}.txt"), "w") as f:
                f.write("\n".join(sel) + "\n")


def write_predictions(root: str, pred_dir: str, k: np.ndarray, hw: tuple) -> int:
    """PoseCNN predictions for each class's test frames: the gt pose
    (gen_gt_observed's pose file) perturbed as sample_rendered_pose
    perturbs, test frame TK_NO_DETECTION of each class without a detection;
    the cube's as a text file, the sphere's in the reference's per-frame
    .mat layout.  Returns the detections written."""
    import scipy.io as sio

    from deepim_tpu_torch.data.pairdb import load_pose_file
    from deepim_tpu_torch.toolkit.gen_rendered_pose import pose_to_line, sample_rendered_pose

    rng = np.random.RandomState(TK_SEED)
    os.makedirs(os.path.join(pred_dir, "sphere"), exist_ok=True)
    detections = 0
    for cls in TK_CLASSES:
        with open(os.path.join(root, "image_set", "observed", f"{cls}_test.txt")) as f:
            test = [x.strip() for x in f if x.strip()]
        lines, icp_lines = [], []
        for i, idx in enumerate(test):
            gt = load_pose_file(os.path.join(root, "data", "gt_observed", cls, idx.split("/")[-1] + "-pose.txt"))
            pose, icp = (sample_rendered_pose(gt, rng, k, hw[1], hw[0])[0] for _ in range(2))
            found = i != TK_NO_DETECTION
            detections += found
            lines.append(pose_to_line(pose) if found else " ".join(["-1"] * 7))
            icp_lines.append(pose_to_line(icp) if found else " ".join(["-1"] * 7))
            if cls == "sphere":
                vec = [np.array([float(x) for x in line.split()]) for line in (lines[-1], icp_lines[-1])]
                sio.savemat(os.path.join(pred_dir, "sphere", f"{i:04d}.mat"),
                            {"rois": np.array([[0.0, 1.0 if found else -1.0, 0, 0, 0, 0, 0]]),
                             "poses": vec[0][None], "poses_icp": vec[1][None]})
        if cls == "cube":
            for name, ls in (("cube_poses.txt", lines), ("cube_poses_icp.txt", icp_lines)):
                with open(os.path.join(pred_dir, name), "w") as f:
                    f.write("\n".join(ls) + "\n")
    return detections


class StageClock:
    """Host seconds of the toolkit's render path split by what it waits on,
    from wrappers installed while a stage runs: rasterize up to a device
    synchronize (render), the rest of BatchRenderer._render_batch (the
    readback), encode_png (PNG encode) and the rest of write_png (file
    writes); the PNG bytes written; each kernel's launches within
    _render_batch, lit and unlit apart, from the wrappers' counts; and the
    first unlit and the first lit rasterize call of each mesh
    (kernel_inputs for check_kernel)."""

    def __init__(self):
        self.totals = dict.fromkeys(("render", "batch", "encode", "png", "png_bytes"), 0.0)
        self.calls = {}
        self.launches = {}

    @contextlib.contextmanager
    def installed(self):
        from deepim_tpu_torch.toolkit import _common
        from deepim_tpu_torch.utils import png

        real_rasterize, real_batch = _common.rasterize, _common.BatchRenderer._render_batch
        real_encode, real_write = png.encode_png, _common.write_png
        tot = self.totals

        def timed(key, fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if key == "render":
                    torch.cuda.synchronize()
                elif key == "encode":
                    tot["png_bytes"] += len(out)
                tot[key] += time.perf_counter() - t0
                return out
            return wrapped

        def render_batch(renderer, poses, corner_colors):
            lit = corner_colors is not renderer._corner_cols
            self.calls.setdefault((renderer._faces.shape[1], lit), (renderer, poses, corner_colors))
            before = launch_counts()
            out = timed_batch(renderer, poses, corner_colors)
            for name, n in launch_counts().items():
                if n != before[name]:
                    self.launches[name, lit] = self.launches.get((name, lit), 0) + n - before[name]
            return out

        timed_batch = timed("batch", real_batch)
        _common.rasterize = timed("render", real_rasterize)
        _common.BatchRenderer._render_batch = render_batch
        png.encode_png = timed("encode", real_encode)
        _common.write_png = timed("png", real_write)
        try:
            yield self
        finally:
            _common.rasterize, _common.BatchRenderer._render_batch = real_rasterize, real_batch
            png.encode_png, _common.write_png = real_encode, real_write


def tk_expected_launches(frames: int, train: int, per_observed: int, syn: int, syn_per_observed: int) -> dict:
    """Each rendering stage's launches of its class's kernel, from the code:
    ceil(n / TK_BATCH) a render_many call (the source: one rasterize call a
    batch of TK_BATCH), twice that in gen-observed (lit and unlit)."""
    def calls(n):
        return -(-n // TK_BATCH)

    test = frames - train
    return {"source": calls(frames), "gen_gt_observed": calls(frames), "gen_rendered": calls(frames * per_observed),
            "gen_posecnn_rendered": calls(test - (test > TK_NO_DETECTION)), "syn gen-observed": 2 * calls(syn),
            "syn gen_rendered": calls(syn * syn_per_observed)}


def run_toolkit_stage(label: str, fn, expect: int, frames: int, clock: StageClock, card: str) -> dict:
    """One stage with the launch counters zeroed just before and read just
    after: its class kernels `expect` times each (csr_raster for the
    sphere, tile_raster for the cube) and nothing else.  Returns the
    stage's wall and clock seconds."""
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    before = dict(clock.totals)
    t0 = time.perf_counter()
    with clock.installed():
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": expect}
    if counts != want:
        raise AssertionError(f"toolkit {label}: launches {counts}, want {want}")
    d = {key: clock.totals[key] - before[key] for key in clock.totals}
    stage = {"wall": wall, "frames": frames, "launches": expect, "render": d["render"],
             "readback": d["batch"] - d["render"], "encode": d["encode"], "write": d["png"] - d["encode"],
             "png_bytes": d["png_bytes"], "out": out}
    stage["other"] = wall - d["batch"] - d["png"]
    per = f"; per frame ({frames}): " + ", ".join(
        f"{key} {stage[key] / frames * 1e3:.3f} ms" for key in ("render", "readback", "encode", "write", "other")
    ) + f", {stage['png_bytes'] / frames / 1e3:.1f} kB of PNG" if frames else ""
    log(f"[toolkit {label}] {wall:.3f} s; launches {counts}{per} [{card}]")
    return stage


def tk_files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs
                  if "cache" not in os.path.relpath(r, root).split(os.sep))


def expected_toolkit_files(frames: int, train: int, per_observed: int, syn: int, syn_per_observed: int,
                           vis: int = 4) -> list:
    """Every file the JAX toolkit writes for this pipeline under the devkit
    root (dk/), the syn root (syn/) and check's --vis-dir (vis/)."""
    out = []
    for ci, cls in enumerate(TK_CLASSES, start=1):
        out += [f"dk/models/{cls}/points.xyz", f"dk/models/{cls}/textured.obj"]
        out += [f"dk/image_set/observed/{cls}_{s}.txt" for s in ("all", "train", "test")]
        test = [f"{i + 1:06d}" for i in range(train, frames)]
        for i in range(1, frames + 1):
            p = f"{i:06d}"
            out += [f"dk/data/observed/{ci:02d}/{p}-{s}" for s in ("color.png", "depth.png", "label.png", "meta.mat")]
            out += [f"dk/data/gt_observed/{cls}/{p}-{s}" for s in ("pose.txt", "depth.png", "label.png", "color.png")]
            out += [f"dk/data/rendered/{cls}/{p}_{j}-{s}" for j in range(per_observed)
                    for s in ("pose.txt", "color.png", "depth.png")]
        for j, p in enumerate(test):
            if j != TK_NO_DETECTION:
                out += [f"dk/data/rendered_val_PoseCNN/{cls}/{p}_0-{s}"
                        for s in ("pose.txt", "pose_icp.txt", "color.png", "depth.png", "label.png")]
        out += [f"dk/rendered_poses/LM6d_all_rendered_pose_{cls}.txt", f"syn/rendered_poses/LM6d_all_rendered_pose_{cls}.txt"]
        out += [f"dk/image_set/{s}_{cls}.txt" for s in ("train", "my_val", "PoseCNN_val")]
        out += [f"syn/image_set/{s}_{cls}.txt" for s in ("train", "my_val")]
        out += [f"syn/image_set/observed/{cls}_all.txt", f"syn/image_set/observed/LM6d_data_syn_train_observed_{cls}.txt"]
        for i in range(1, syn + 1):
            p = f"{i:06d}"
            out += [f"syn/data/observed/{cls}/{p}-{s}" for s in ("color.png", "depth.png", "label.png", "pose.txt")]
            out += [f"syn/data/gt_observed/{cls}/{p}-{s}" for s in ("color.png", "depth.png", "pose.txt")]
            out += [f"syn/data/rendered/{cls}/{p}_{j}-{s}" for j in range(syn_per_observed)
                    for s in ("pose.txt", "color.png", "depth.png")]
        out += [f"vis/{cls}_{i:06d}_check.png" for i in range(1, min(vis, syn * syn_per_observed) + 1)]
    out += ["dk/models/models_info.txt", "dk/models/extents.txt", "syn/poses/LM6d_ds_train_observed_pose_all.pkl"]
    return sorted(out)


def toolkit_mains(src: str, base: str, frames: int, train: int, per_observed: int, syn: int,
                  syn_per_observed: int, clock: StageClock, dev, card: str) -> dict:
    """15A: the toolkit's CLIs in order, each through its main(argv) with
    --device `dev`, on the BOP source `src` into <base>/dk, <base>/syn and
    <base>/vis.  Returns each stage's figures."""
    from deepim_tpu_torch.toolkit import adapt_devkit, gen_gt_observed, gen_posecnn_rendered, gen_rendered
    from deepim_tpu_torch.toolkit import gen_rendered_pose, stats, syn_poses

    dk, syn_root, preds = (os.path.join(base, d) for d in ("dk", "syn", "preds"))
    cls_args = ["--classes", *TK_CLASSES, "--device", str(dev)]
    expect = tk_expected_launches(frames, train, per_observed, syn, syn_per_observed)
    test = frames - train
    stages = {}

    def stage(label, fn, n_frames=0):
        stages[label] = run_toolkit_stage(label, fn, expect.get(label, 0), n_frames, clock, card)
        return stages[label]["out"]

    stage("rescale-models", lambda: adapt_devkit.main(["rescale-models", "--origin-models", os.path.join(src, "models"),
                                                       "--out-models", os.path.join(dk, "models"), *cls_args]))
    stage("calc-extents", lambda: adapt_devkit.main(["calc-extents", "--models-dir", os.path.join(dk, "models"),
                                                     *cls_args]))
    stage("adapt-images", lambda: adapt_devkit.main(["adapt-images", "--origin-root", os.path.join(src, "test"),
                                                     "--out-root", dk, *cls_args]), 2 * frames)
    write_splits(dk, train)
    stage("gen_gt_observed", lambda: gen_gt_observed.main(["--root", dk, *cls_args]), 2 * frames)
    stage("gen_rendered_pose", lambda: gen_rendered_pose.main(["--root", dk, "--per-observed", str(per_observed),
                                                               *cls_args]))
    stage("gen_rendered", lambda: gen_rendered.main(["--root", dk, "--per-observed", str(per_observed), *cls_args]),
          2 * frames * per_observed)
    detections = write_predictions(dk, preds, TK_K, (H, W))
    stage("gen_posecnn_rendered", lambda: gen_posecnn_rendered.main(["--root", dk, "--pred-dir", preds, *cls_args]),
          detections)
    stage("syn gen-poses", lambda: syn_poses.main(["gen-poses", "--real-root", dk, "--syn-root", syn_root,
                                                   "--num-images", str(syn), *cls_args]))
    os.symlink(os.path.join(dk, "models"), os.path.join(syn_root, "models"))
    stage("syn gen-observed", lambda: syn_poses.main(["gen-observed", "--syn-root", syn_root, *cls_args]), 4 * syn)
    stage("syn gen_rendered_pose", lambda: gen_rendered_pose.main(
        ["--root", syn_root, "--per-observed", str(syn_per_observed), *cls_args]))
    stage("syn gen_rendered", lambda: gen_rendered.main(
        ["--root", syn_root, "--per-observed", str(syn_per_observed), *cls_args]), 2 * syn * syn_per_observed)
    report = stage("syn check", lambda: syn_poses.main(["check", "--syn-root", syn_root, "--vis-dir",
                                                        os.path.join(base, "vis"), *cls_args]))
    if report["missing"] or report["label_mismatch"] or report["pairs"] != 2 * syn * syn_per_observed:
        raise AssertionError(f"toolkit syn check: {report}")
    stages["stats"] = {cls: run_toolkit_stage(f"stats train_{cls}", lambda c=cls: stats.main(
        ["--root", dk, "--image-set", f"train_{c}", "--cls", c, "--device", str(dev)]), 0, 0, clock, card)["out"]
        for cls in TK_CLASSES}
    for cls, out in stages["stats"].items():
        if not (np.isfinite(out["se3"][0]).all() and np.isfinite(out["se3"][1]).all() and out["se3"][0][0] > 0.8):
            raise AssertionError(f"toolkit stats {cls}: {out}")
        log(f"[toolkit stats train_{cls}] stat_se3 mean {[round(float(x), 5) for x in out['se3'][0]]}, std "
            f"{[round(float(x), 5) for x in out['se3'][1]]}; depth max/min {out['depth']} [{card}]")
    return stages


def check_toolkit_layout(base: str, src_poses: dict, frames: int, train: int, per_observed: int, syn: int,
                         syn_per_observed: int, card: str) -> None:
    """Exactly the files the JAX pipeline writes (the PairDB caches aside),
    each -meta.mat pose within 1e-5 of its source, and gen_rendered_pose's
    file byte-equal to a CPU run's with the same seed."""
    import scipy.io as sio

    from deepim_tpu_torch.toolkit import gen_rendered_pose

    got = [p for p in tk_files(base) if not p.startswith("preds/")]
    want = expected_toolkit_files(frames, train, per_observed, syn, syn_per_observed)
    if got != want:
        raise AssertionError(f"toolkit layout: missing {sorted(set(want) - set(got))[:8]}, "
                             f"extra {sorted(set(got) - set(want))[:8]}")
    err = 0.0
    for ci, cls in enumerate(TK_CLASSES, start=1):
        for i, pose in enumerate(src_poses[cls]):
            meta = sio.loadmat(os.path.join(base, "dk", "data", "observed", f"{ci:02d}", f"{i + 1:06d}-meta.mat"))
            err = max(err, float(np.abs(meta["poses"][:, :, 0] - pose).max()))
            if meta["cls_indexes"].tolist() != [[ci]]:
                raise AssertionError(f"toolkit meta {cls} {i}: cls_indexes {meta['cls_indexes']}")
    if err > 1e-5:
        raise AssertionError(f"toolkit -meta.mat poses {err} from their source")
    cpu = os.path.join(PHASE15_DIR, "pose_cpu")
    shutil.copytree(os.path.join(base, "dk", "image_set"), os.path.join(cpu, "image_set"))
    shutil.copytree(os.path.join(base, "dk", "data", "observed"), os.path.join(cpu, "data", "observed"),
                    ignore=shutil.ignore_patterns("*.png"))
    gen_rendered_pose.main(["--root", cpu, "--per-observed", str(per_observed), "--classes", *TK_CLASSES,
                            "--device", "cpu"])
    for cls in TK_CLASSES:
        name = f"LM6d_all_rendered_pose_{cls}.txt"
        with open(os.path.join(base, "dk", "rendered_poses", name), "rb") as a, \
                open(os.path.join(cpu, "rendered_poses", name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"toolkit gen_rendered_pose: {name} differs from the CPU run's")
    log(f"[toolkit layout] {len(got)} files, exactly the JAX pipeline's; -meta.mat poses within {err:.3g} of the "
        f"source; gen_rendered_pose's files byte-equal to a CPU run's [{card}]")


def sphere_dropped_pairs(base: str, dev) -> tuple:
    """csr_dropped_pairs summed over every pose the toolkit rendered the
    sphere at (its pose files), with the toolkit's RasterConfig, and the
    number of poses."""
    from deepim_tpu_torch.data.pairdb import load_pose_file
    from deepim_tpu_torch.render.mesh import load_textured_mesh
    from deepim_tpu_torch.render.rasterizer import csr_dropped_pairs

    paths = [os.path.join(r, f) for sub in ("dk", "syn") for r, _, fs in os.walk(os.path.join(base, sub, "data"))
             for f in fs if f.endswith("-pose.txt") and os.sep + "sphere" + os.sep in os.path.join(r, "")]
    poses = np.stack([load_pose_file(p) for p in sorted(paths)])
    mesh = load_textured_mesh(os.path.join(base, "dk", "models", "sphere"))
    verts, faces = (torch.from_numpy(np.repeat(a[None], TK_BATCH, 0)) for a in (mesh.vertices, mesh.faces))
    fvalid = torch.ones(faces.shape[:2], dtype=torch.bool)
    dropped = 0
    for start in range(0, len(poses), TK_BATCH):
        chunk = torch.from_numpy(poses[start:start + TK_BATCH])
        n = chunk.shape[0]
        dropped += int(csr_dropped_pairs(verts[:n], faces[:n], fvalid[:n], chunk, torch.from_numpy(TK_K),
                                         RasterConfig(height=H, width=W), device=dev))
    return dropped, len(poses)


def toolkit_small(src: str, root: str, dev) -> dict:
    """15B: the same pipeline through the toolkit's functions at
    TK_SMALL x TK_SMALL with K64 on `dev`, into `root`."""
    from deepim_tpu_torch.data.pairdb import PairDB
    from deepim_tpu_torch.toolkit import adapt_devkit, gen_gt_observed, gen_posecnn_rendered, gen_rendered
    from deepim_tpu_torch.toolkit import gen_rendered_pose, stats, syn_poses

    kw = dict(k=K64, width=TK_SMALL, height=TK_SMALL)
    dk, syn_root, preds = (os.path.join(root, d) for d in ("dk", "syn", "preds"))
    classes = list(TK_CLASSES)
    adapt_devkit.rescale_models(os.path.join(src, "models"), os.path.join(dk, "models"), classes)
    adapt_devkit.calc_extents(os.path.join(dk, "models"), classes)
    adapt_devkit.adapt_images(os.path.join(src, "test"), dk, classes)
    write_splits(dk, TK_SMALL_TRAIN)
    gen_gt_observed.gen_gt_observed(dk, classes, batch=TK_BATCH, device=dev, **kw)
    gen_rendered_pose.gen_rendered_pose(dk, classes, per_observed=2, **kw)
    gen_rendered.gen_rendered(dk, classes, per_observed=2, batch=TK_BATCH, device=dev, **kw)
    write_predictions(dk, preds, K64, (TK_SMALL, TK_SMALL))
    gen_posecnn_rendered.gen_posecnn_rendered(dk, preds, classes, batch=TK_BATCH, device=dev, **kw)
    syn_poses.gen_poses(dk, syn_root, classes, num_images=TK_SMALL_SYN, margin=8, **kw)
    os.symlink(os.path.join(dk, "models"), os.path.join(syn_root, "models"))
    syn_poses.gen_observed(syn_root, classes, batch=TK_BATCH, device=dev, **kw)
    gen_rendered_pose.gen_rendered_pose(syn_root, classes, per_observed=1, **kw)
    gen_rendered.gen_rendered(syn_root, classes, per_observed=1, batch=TK_BATCH, device=dev, **kw)
    report = syn_poses.check(syn_root, classes, vis_dir=os.path.join(root, "vis"))
    pairdb = PairDB(name="LM6D_REFINE", devkit_path=dk, image_set="train_sphere", cur_class="sphere").gt_pairdb()
    return {"check": report, "se3": stats.stat_se3(pairdb, device=dev), "depth": stats.stat_depth(pairdb)}


def toolkit_card_vs_cpu(dev, card: str) -> dict:
    """15B: toolkit_small on the card and on the CPU from one 64x64 source;
    every file equal (PNGs after decoding: depth and labels at every pixel,
    rgb within 1 level), stat_se3 to 1e-5, the check reports equal, and
    the card's launches exactly the planned count."""
    import scipy.io as sio

    meshes = {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 4)}
    src = os.path.join(PHASE15_DIR, "small", "src")
    write_bop_source(src, meshes, TK_SMALL_FRAMES, K64, (TK_SMALL, TK_SMALL), "cpu")
    roots = {d: os.path.join(PHASE15_DIR, "small", d) for d in ("cuda", "cpu")}
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    out = {"cuda": toolkit_small(src, roots["cuda"], dev)}
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    plan = tk_expected_launches(TK_SMALL_FRAMES, TK_SMALL_TRAIN, 2, TK_SMALL_SYN, 1)
    n = sum(v for key, v in plan.items() if key != "source")
    if counts != {"csr_raster": n, "csr_planes_raster": 0, "tile_raster": n}:
        raise AssertionError(f"toolkit 64x64: launches {counts}, want csr_raster and tile_raster {n} each")
    t0 = time.perf_counter()
    out["cpu"] = toolkit_small(src, roots["cpu"], "cpu")
    cpu_s = time.perf_counter() - t0
    files = tk_files(roots["cpu"])
    if files != tk_files(roots["cuda"]):
        raise AssertionError(f"toolkit 64x64: the card wrote {sorted(set(files) ^ set(tk_files(roots['cuda'])))}")
    pngs = rgb_off = 0
    for rel in files:
        a, b = (os.path.join(roots[d], rel) for d in ("cuda", "cpu"))
        if rel.endswith(".png"):
            x, y = read_png(a).astype(np.int32), read_png(b).astype(np.int32)
            pngs += 1
            colour = x.ndim == 3
            if x.shape != y.shape or np.abs(x - y).max() > (1 if colour else 0):
                raise AssertionError(f"toolkit 64x64: {rel} differs between the card and the CPU")
            rgb_off += int((x != y).any(-1).sum()) if colour else 0
        elif rel.endswith(".mat"):
            ma, mb = sio.loadmat(a), sio.loadmat(b)
            if any(not np.array_equal(ma[key], mb[key]) for key in ma if not key.startswith("__")):
                raise AssertionError(f"toolkit 64x64: {rel} differs between the card and the CPU")
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"toolkit 64x64: {rel} differs between the card and the CPU")
    se3_err = max(float(np.abs(x - y).max()) for x, y in zip(out["cuda"]["se3"], out["cpu"]["se3"]))
    if se3_err > 1e-5 or out["cuda"]["check"] != out["cpu"]["check"] or out["cuda"]["depth"] != out["cpu"]["depth"]:
        raise AssertionError(f"toolkit 64x64: stats or check differ: {out}")
    log(f"[toolkit 64x64] card vs CPU: {len(files)} files ({pngs} PNGs) equal, {rgb_off} colour pixels one level "
        f"apart; stat_se3 max diff {se3_err:.3g}; card {card_s:.3f} s (launches {counts}), CPU {cpu_s:.3f} s "
        f"[{card}]")
    return out


def toolkit_test_deepim(dk: str, dev, card: str) -> dict:
    """15D: test_deepim with the recipe file on the PoseCNN_val_ sets the
    toolkit wrote (batch 16, 4 iterations, bf16, a seeded checkpoint):
    csr_raster (the bank pads both classes past 2,048 faces) launched
    exactly as planned and nothing else, every table finite, no dropped
    pair."""
    cfg = update_config_dict(load_config(EVAL_CFG), {
        "output_path": os.path.join(PHASE15_DIR, "output"),
        "dataset": {"dataset_path": dk, "root_path": dk, "model_dir": os.path.join(dk, "models"),
                    "class_name": list(TK_CLASSES), "NUM_CLASSES": len(TK_CLASSES),
                    "test_image_set": "PoseCNN_val_"},
    })
    cfg = validate_config(cfg)
    classes, n_iter = list(cfg.dataset.class_name), cfg.TEST.test_iter
    pairs = {cls: len(load_gt_pairdb(cfg, "LM6D_REFINE", f"PoseCNN_val_{cls}", cls, dk, dk)[1]) for cls in classes}
    expect = n_iter * sum(math.ceil(n / EVAL_B) for n in pairs.values())
    out = os.path.join(PHASE15_DIR, "output", "test")
    save_checkpoint(os.path.join(out, cfg.TRAIN.model_prefix), cfg.TEST.test_epoch,
                    TrainState(make_model(True, 15, dev, hw=(cfg.height, cfg.width)), None))
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    res = test_deepim(cfg, output_dir=out, batch_size=EVAL_B, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"toolkit test_deepim: launches {counts}, want csr_raster {expect}")
    run = res["run"]
    if run["pairs"] != sum(pairs.values()) or run["raster_dropped"]:
        raise AssertionError(f"toolkit test_deepim: {run}")
    check_tables("toolkit test_deepim", res, classes, n_iter)
    loop_s = run["data_s"] + run["net_s"]
    log(f"[toolkit test_deepim] PoseCNN_val_ of the adapted devkit ({pairs} pairs, batch {EVAL_B}, {n_iter} "
        f"iterations, bf16): {run['pairs'] / loop_s:.2f} frames/s over pred_eval's loop (data {run['data_s']:.3f} s + "
        f"net {run['net_s']:.3f} s), the call {wall:.3f} s; launches {counts}; every table finite, no dropped pair; "
        f"iteration {n_iter} 5cm5deg {[round(res['pose'][c][n_iter - 1]['acc_5cm_5deg'], 4) for c in classes]} "
        f"[{card}]")
    return {"launches": expect, "frames_s": run["pairs"] / loop_s}


def drive_phase15(dev, card: str) -> dict:
    """Phase 15: the BOP source, 15A (the CLIs), the layout and drop checks,
    both kernels against their twins at the toolkit's renders (15C), 15B
    and 15D.  Returns each kernel's checks (toolkit_, toolkit_lit_ keys)."""
    shutil.rmtree(PHASE15_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    meshes = {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 5)}
    base, src = os.path.join(PHASE15_DIR, "full"), os.path.join(PHASE15_DIR, "src")
    clock = StageClock()
    plan = tk_expected_launches(TK_FRAMES, TK_TRAIN, TK_PER_OBSERVED, TK_SYN, TK_SYN_PER_OBSERVED)
    source = run_toolkit_stage("source (BOP)", lambda: write_bop_source(src, meshes, TK_FRAMES, TK_K, (H, W), dev),
                               plan["source"], 0, clock, card)
    stages = toolkit_mains(src, base, TK_FRAMES, TK_TRAIN, TK_PER_OBSERVED, TK_SYN, TK_SYN_PER_OBSERVED, clock, dev,
                           card)
    check_toolkit_layout(base, source["out"], TK_FRAMES, TK_TRAIN, TK_PER_OBSERVED, TK_SYN, TK_SYN_PER_OBSERVED, card)
    dropped, n_poses = sphere_dropped_pairs(base, dev)
    if dropped:
        raise AssertionError(f"toolkit: {dropped} face-tile pairs dropped over the sphere's {n_poses} poses")
    # Launches within BatchRenderer over the toolkit's stages, lit and
    # unlit as counted there, against the plan: gen-observed's lit half is
    # the only lit rendering.
    lit_plan = plan["syn gen-observed"] // 2
    unlit_plan = sum(n for label, n in plan.items() if label != "source") - lit_plan
    want = {(name, lit): n for name in ("csr_raster", "tile_raster") for lit, n in ((False, unlit_plan),
                                                                                   (True, lit_plan))}
    if clock.launches != want:
        raise AssertionError(f"toolkit: launches within BatchRenderer {clock.launches}, want {want}")
    checks = {}
    for (nfaces, lit), (renderer, poses, corner_colors) in sorted(clock.calls.items()):
        (name, args), = kernel_inputs(renderer._verts, renderer._cols, renderer._faces, renderer._fvalid, poses,
                                      renderer._k, renderer.cfg, corners=renderer._corners,
                                      corner_colors=corner_colors, device=dev)
        if name != ("csr_raster" if nfaces > 2048 else "tile_raster"):
            raise AssertionError(f"toolkit: a {nfaces}-face render plans {name}")
        check = check_kernel(name, args, card, shape=f"toolkit {'lit' if lit else 'unlit'} ({nfaces} faces)")
        if check["max_abs_err"] != 0.0:
            raise AssertionError(f"toolkit: {name} differs from its twin by {check['max_abs_err']}")
        del check["out"]
        check["launches"] = clock.launches[name, lit]
        checks.setdefault(name, {})["toolkit_lit" if lit else "toolkit"] = check
    if sorted((n, sorted(c)) for n, c in checks.items()) != [("csr_raster", ["toolkit", "toolkit_lit"]),
                                                            ("tile_raster", ["toolkit", "toolkit_lit"])]:
        raise AssertionError(f"toolkit: kernel checks {sorted(checks)}")
    toolkit_card_vs_cpu(dev, card)
    deepim = toolkit_test_deepim(os.path.join(base, "dk"), dev, card)
    rendering = [s for label, s in stages.items() if label != "stats" and s["frames"]]
    frames = sum(s["frames"] for s in rendering)
    log(f"[toolkit] {frames} frames written by the rendering stages at {H}x{W}: "
        + ", ".join(f"{key} {sum(s[key] for s in rendering) / frames * 1e3:.3f} ms"
                    for key in ("render", "readback", "encode", "write", "other"))
        + f" a frame, {sum(s['png_bytes'] for s in rendering) / frames / 1e3:.1f} kB of PNG a frame; launches "
        f"within BatchRenderer (kernel, lit): {sorted(clock.launches.items())}; no dropped "
        f"pair over the sphere's {n_poses} poses; test_deepim {deepim['frames_s']:.2f} frames/s; phase 15 "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return checks


# Phase 16: the training recipe as written, fine-tuning a FlowNet from an
# MXNet .params file, with VOC JPEG backgrounds (files written here, under
# a gitignored directory, and removed at the end of the phase).
PHASE16_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase16")
RECIPE_PAIRS = 8      # sphere training pairs, read as LM6D_REFINE and as LM6D_REFINE_SYN: 4 steps of batch 4
RECIPE_BG_RATIO = 0.5
FLOWNET_SEED = 16
# The VOC pool: (height, width) of VOC2012's common sizes, and each file's
# encoding (chroma sampling, restart interval in MCUs).
VOC_POOL = (((375, 500), "420", 0), ((333, 500), "444", 0), ((500, 375), "420", 4), ((375, 500), "444", 0))
VOC_QUALITY = 90
VOC_MIN_PSNR = 30.0   # dB of a decoded background against its source
# The vanilla FlowNetS the recipe fine-tunes (deepIM_flownet.py:63-230):
# name -> (out, in, kernel); the first layer reads two BGR images.
FLOWNET_CONVS = (("flow_conv1", 64, 6, 7), ("conv2", 128, 64, 5), ("conv3", 256, 128, 5), ("conv3_1", 256, 256, 3),
                 ("conv4", 512, 256, 3), ("conv4_1", 512, 512, 3), ("conv5", 512, 512, 3), ("conv5_1", 512, 512, 3),
                 ("conv6", 1024, 512, 3), ("conv6_1", 1024, 1024, 3), ("Convolution1", 2, 1024, 3),
                 ("Convolution2", 2, 1026, 3), ("Convolution3", 2, 770, 3))
FLOWNET_DECONVS = (("deconv5", 1024, 512), ("deconv4", 1026, 256), ("upsample_flow6to5", 2, 2),
                   ("upsample_flow5to4", 2, 2))
HEAD_LAYERS = ("fc6", "fc7", "rot", "trans", "mask_conv3")


def write_flownet_params(path: str) -> dict:
    """A seeded vanilla-FlowNetS checkpoint in the reference's format
    (save_mxnet_params, "arg:" names): the encoder, deconv5/deconv4, the
    flow predictors and upsamplers, the frozen bilinear upsampling_weight;
    no fc/rot/trans or mask heads.  Weights are normal with a standard
    deviation of 1/sqrt(fan_in), biases 0.01 normal.  Returns the arrays."""
    from deepim_tpu_torch.models.import_mxnet import bilinear_kernel
    from deepim_tpu_torch.utils.mxnet_io import save_mxnet_params

    rng = np.random.default_rng(FLOWNET_SEED)
    arrays = {}
    for name, cout, cin, k in FLOWNET_CONVS:
        scale = np.float32(math.sqrt(cin * k * k))
        arrays[f"{name}_weight"] = rng.standard_normal((cout, cin, k, k), np.float32) / scale
        arrays[f"{name}_bias"] = rng.standard_normal(cout, np.float32) * np.float32(0.01)
    for name, cin, cout in FLOWNET_DECONVS:
        arrays[f"{name}_weight"] = rng.standard_normal((cin, cout, 4, 4), np.float32) / np.float32(math.sqrt(cin * 4))
        arrays[f"{name}_bias"] = rng.standard_normal(cout, np.float32) * np.float32(0.01)
    arrays["upsampling_weight"] = bilinear_kernel(2)
    save_mxnet_params(path, arrays)
    return arrays


# -- a baseline JPEG encoder (the VOC pool's files; the package decodes only) --

def _zigzag() -> np.ndarray:
    """Natural index of each zig-zag position."""
    cells = sorted(((i + j, i if (i + j) % 2 else j, i * 8 + j) for i in range(8) for j in range(8)))
    return np.array([c[2] for c in cells])


ZIGZAG = _zigzag()
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                   14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of a base table (natural order)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_lengths(freq: dict) -> tuple[list, list]:
    """JPEG's optimal code for symbol frequencies, limited to 16 bits with
    no all-ones code (Annex K.2, libjpeg's jpeg_gen_optimal_table): (counts
    of codes of each length 1-16, symbols in code order)."""
    f = [freq.get(i, 0) for i in range(256)] + [1]
    size, others = [0] * 257, [-1] * 257
    while True:
        used = [i for i in range(257) if f[i]]
        if len(used) < 2:
            break
        c1 = max(used, key=lambda i: (-f[i], i))
        c2 = max((i for i in used if i != c1), key=lambda i: (-f[i], i))
        f[c1] += f[c2]
        f[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [s for length in range(1, 33) for s in range(256) if size[s] == length]
    return bits[1:17], symbols


def _canonical_codes(counts: list, symbols: list) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _size_bits(v: int) -> tuple[int, int]:
    """(size category, the value's extra bits) of a DC difference or AC
    coefficient."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _jpeg_blocks(rgb: np.ndarray, quality: int, sampling: str) -> tuple:
    """The quantised coefficients of an (h, w, 3) uint8 RGB image as a JFIF
    encoder makes them: YCbCr, 4:2:0 or 4:4:4 chroma, float DCT, libjpeg's
    quality-scaled tables.  Returns (blocks, qtabs, hv, mh, mw): per
    component (rows, cols, 64) int64 in zig-zag order over whole MCUs, the
    two tables, the luma sampling factor and the MCU rows and columns."""
    h, w = rgb.shape[:2]
    f = rgb.astype(np.float64)
    ycc = [0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
           -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128,
           0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128]
    hv = 2 if sampling == "420" else 1
    mcu = 8 * hv
    mh, mw = -(-h // mcu), -(-w // mcu)
    n = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    qtabs = [_quant_table(LUMA_Q, quality), _quant_table(CHROMA_Q, quality)]
    blocks = []
    for ci, p in enumerate(ycc):
        p = np.pad(p, ((0, mh * mcu - h), (0, mw * mcu - w)), mode="edge")
        if ci and hv == 2:
            p = p.reshape(mh * 8, 2, mw * 8, 2).mean(axis=(1, 3))
        b = (p - 128).reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        c = np.einsum("ui,rcij,vj->rcuv", dct, b, dct).reshape(b.shape[0], b.shape[1], 64)
        blocks.append(np.round(c / qtabs[min(ci, 1)]).astype(np.int64)[:, :, ZIGZAG])
    return blocks, qtabs, hv, mh, mw


def _mcu_blocks(blocks: list, hv: int, mh: int, mw: int) -> list:
    """The blocks of an interleaved scan in decode order: (component, zig-zag
    coefficients) for every block of every MCU."""
    order = [(0, dy, dx) for dy in range(hv) for dx in range(hv)] + [(1, 0, 0), (2, 0, 0)]
    rows = [b.tolist() for b in blocks]
    out = []
    for m in range(mh * mw):
        my, mx = divmod(m, mw)
        for ci, dy, dx in order:
            s = hv if ci == 0 else 1
            out.append((ci, rows[ci][my * s + dy][mx * s + dx]))
    return out


def _baseline_scan(blocks, hv, mh, mw, restart: int) -> tuple:
    """One interleaved sequential scan: its symbols (table, symbol, extra
    bits, extra length; tables 0/2 DC and 1/3 AC of luma/chroma) and the
    index of the first symbol of each restart interval."""
    per_mcu = hv * hv + 2
    syms, starts, pred = [], [], [0, 0, 0]
    for i, (ci, zz) in enumerate(_mcu_blocks(blocks, hv, mh, mw)):
        if restart and i % (restart * per_mcu) == 0:
            starts.append(len(syms))
            pred = [0, 0, 0]
        t = min(ci, 1)
        s, v = _size_bits(zz[0] - pred[ci])
        pred[ci] = zz[0]
        syms.append((2 * t, s, v, s))
        last = 0
        for k in range(1, 64):
            if not zz[k]:
                continue
            run = k - last - 1
            while run > 15:
                syms.append((2 * t + 1, 0xF0, 0, 0))
                run -= 16
            s, v = _size_bits(zz[k])
            syms.append((2 * t + 1, (run << 4) | s, v, s))
            last = k
        if last < 63:
            syms.append((2 * t + 1, 0x00, 0, 0))
    return syms, starts


# libjpeg's jpeg_simple_progression for three-component YCbCr: (components,
# Ss, Se, Ah, Al) of each scan.
SIMPLE_PROGRESSION = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                      ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                      ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))


def _progressive_scan(blocks, hv, mh, mw, h, w, comps, ss, se, ah, al, restart: int) -> tuple:
    """One scan of a progressive file as libjpeg's jcphuff.c codes it: DC
    first (difference of coefficient >> Al) and DC refinement (bit Al),
    AC first (run/size symbols of |coefficient| >> Al with EOB runs) and AC
    refinement (new coefficients of magnitude 1 with their sign, and a
    correction bit for each coefficient already nonzero, buffered with EOB
    runs).  Symbols as _baseline_scan's; table -1 marks raw bits."""
    syms, starts = [], []
    if ss == 0:
        blist = _mcu_blocks(blocks, hv, mh, mw)
        per_mcu = hv * hv + 2
    else:
        (ci,) = comps
        sub = hv if ci else 1  # chroma is subsampled by the luma factor
        bh, bw = -(-(-(-h // sub)) // 8), -(-(-(-w // sub)) // 8)
        rows = blocks[ci].tolist()
        blist = [(ci, rows[by][bx]) for by in range(bh) for bx in range(bw)]
        per_mcu = 1
    pred = [0, 0, 0]
    eob, be = 0, []

    def flush():
        nonlocal eob, be
        if eob:
            n = eob.bit_length() - 1
            syms.append((table, n << 4, eob & ((1 << n) - 1), n))
            syms.extend((-1, 0, bit, 1) for bit in be)
            eob, be = 0, []

    for i, (ci, zz) in enumerate(blist):
        table = 2 * min(ci, 1) + (ss > 0)
        if restart and i % (restart * per_mcu) == 0:
            flush()
            starts.append(len(syms))
            pred = [0, 0, 0]
        if ss == 0:
            if ah == 0:
                v = zz[0] >> al
                s, bits = _size_bits(v - pred[ci])
                pred[ci] = v
                syms.append((table, s, bits, s))
            else:
                syms.append((-1, 0, (zz[0] >> al) & 1, 1))
            continue
        absv = [abs(zz[k]) >> al for k in range(ss, se + 1)]
        run, br = 0, []
        if ah == 0:
            for k, a in zip(range(ss, se + 1), absv):
                if not a:
                    run += 1
                    continue
                flush()
                while run > 15:
                    syms.append((table, 0xF0, 0, 0))
                    run -= 16
                n = a.bit_length()
                syms.append((table, (run << 4) | n, a if zz[k] > 0 else (~a) & ((1 << n) - 1), n))
                run = 0
        else:
            last_new = max((k for k, a in zip(range(ss, se + 1), absv) if a == 1), default=0)
            for k, a in zip(range(ss, se + 1), absv):
                if not a:
                    run += 1
                    continue
                while run > 15 and k <= last_new:
                    flush()
                    syms.append((table, 0xF0, 0, 0))
                    run -= 16
                    syms.extend((-1, 0, bit, 1) for bit in br)
                    br = []
                if a > 1:
                    br.append(a & 1)
                    continue
                flush()
                syms.append((table, (run << 4) | 1, 0, 0))
                syms.append((-1, 0, int(zz[k] > 0), 1))
                syms.extend((-1, 0, bit, 1) for bit in br)
                br, run = [], 0
        if run or br:
            eob += 1
            be.extend(br)
            if eob == 0x7FFF or len(be) > 1000 - 64 + 1:
                flush()
    if blist:
        table = 2 * min(blist[-1][0], 1) + (ss > 0)
        flush()
    return syms, starts


def encode_jpeg(rgb: np.ndarray, quality: int = VOC_QUALITY, sampling: str = "420", restart: int = 0,
                progressive: bool = False) -> bytes:
    """A JFIF JPEG of an (h, w, 3) uint8 RGB image (_jpeg_blocks'
    coefficients) with optimal Huffman tables and, with `restart`, a
    restart marker every `restart` MCUs: baseline (SOF0, one interleaved
    scan), or progressive (SOF2, libjpeg's simple progression script, a
    Huffman table per scan) from the same quantised coefficients, so the
    two decode to the same pixels."""
    h, w = rgb.shape[:2]
    blocks, qtabs, hv, mh, mw = _jpeg_blocks(rgb, quality, sampling)

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [segment(0xDB, bytes([t]) + bytes(int(x) for x in q[ZIGZAG])) for t, q in enumerate(qtabs)]
    samp = [(hv << 4) | hv, 0x11, 0x11]
    out.append(segment(0xC2 if progressive else 0xC0, struct.pack(">BHHB", 8, h, w, 3)
                       + b"".join(bytes([ci + 1, samp[ci], min(ci, 1)]) for ci in range(3))))
    if restart:
        out.append(segment(0xDD, struct.pack(">H", restart)))
    scans = (SIMPLE_PROGRESSION if progressive else (((0, 1, 2), 0, 63, 0, 0),))
    for comps, ss, se, ah, al in scans:
        if progressive:
            syms, starts = _progressive_scan(blocks, hv, mh, mw, h, w, comps, ss, se, ah, al, restart)
        else:
            syms, starts = _baseline_scan(blocks, hv, mh, mw, restart)
        codes = {}
        for tid in range(4):
            freq = {}
            for table, sym, _, _ in syms:
                if table == tid:
                    freq[sym] = freq.get(sym, 0) + 1
            if freq:
                counts, symbols = _huffman_lengths(freq)
                codes[tid] = _canonical_codes(counts, symbols)
                out.append(segment(0xC4, bytes([(tid % 2) << 4 | tid // 2]) + bytes(counts) + bytes(symbols)))
        vals = np.array([v if t < 0 else (codes[t][s][0] << n) | v for t, s, v, n in syms] or [0], np.uint64)
        lens = np.array([n if t < 0 else codes[t][s][1] + n for t, s, _, n in syms] or [0], np.int64)

        def pack(lo: int, hi: int) -> bytes:
            v, ln = vals[lo:hi], lens[lo:hi]
            total = int(ln.sum())
            offs = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
            bits = (np.repeat(v, ln) >> np.repeat(ln, ln).astype(np.uint64) - 1 - offs.astype(np.uint64)) & 1
            bits = np.concatenate([bits.astype(np.uint8), np.ones(-total % 8, np.uint8)])
            return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")

        bounds = (starts or [0]) + [len(syms)]
        data = b"".join(pack(lo, hi) + (bytes([0xFF, 0xD0 + i % 8]) if i + 2 < len(bounds) else b"")
                        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])))
        sos = bytes([len(comps)]) + b"".join(bytes([ci + 1, min(ci, 1) * 0x11]) for ci in comps)
        out.append(segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])) + data)
    return b"".join(out) + b"\xff\xd9"


def voc_scene(hw: tuple, seed: int) -> np.ndarray:
    """A seeded (h, w, 3) uint8 stand-in for a VOC photograph: smooth
    shading, a few flat and textured rectangles, mild noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([90 + 80 * np.sin(xx / 53 + c) * np.cos(yy / 37 - c) + 40 * c for c in range(3)], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
        y1, x1 = y0 + rng.integers(20, h // 2), x0 + rng.integers(20, w // 2)
        colour = rng.uniform(20, 235, 3)
        stripes = 25 * np.sin(xx[y0:y1, x0:x1, None] / rng.uniform(2, 9)) if rng.random() < 0.5 else 0
        img[y0:y1, x0:x1] = colour + stripes
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def write_voc_pool(root: str, card: str) -> dict:
    """VOCdevkit/VOC2012 under `root` as the reference lays it out: the
    pool's JPEGs (encode_jpeg) listed with label 1 in
    ImageSets/Main/diningtable_trainval.txt.  Decodes each with the port's
    read_jpeg on the host CPU, checks it against its source (shape, PSNR)
    and returns the decode times."""
    from deepim_tpu_torch.utils.jpeg import read_jpeg

    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    os.makedirs(os.path.join(voc, "ImageSets", "Main"))
    os.makedirs(os.path.join(voc, "JPEGImages"))
    lines, decode_ms, psnr, sizes = [], [], [], []
    for i, (hw, sampling, restart) in enumerate(VOC_POOL):
        src = voc_scene(hw, FLOWNET_SEED + i)
        data = encode_jpeg(src, VOC_QUALITY, sampling, restart)
        path = os.path.join(voc, "JPEGImages", f"2008_{i:06d}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        back = read_jpeg(path)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        mse = float(((back.astype(np.float64) - src) ** 2).mean())
        psnr.append(10 * math.log10(255 ** 2 / max(mse, 1e-12)))
        if back.shape != src.shape or psnr[-1] < VOC_MIN_PSNR:
            raise AssertionError(f"VOC pool: {path} decodes to {back.shape} at {psnr[-1]:.1f} dB, want {src.shape} "
                                 f"at {VOC_MIN_PSNR} dB or more")
        sizes.append(len(data))
        lines.append(f"2008_{i:06d}  1")
    with open(os.path.join(voc, "ImageSets", "Main", "diningtable_trainval.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    files = ", ".join(f"{hw[1]}x{hw[0]} {s}" + (f" RST every {r}" if r else "") for hw, s, r in VOC_POOL)
    log(f"[recipe] VOC pool: {len(VOC_POOL)} baseline JPEGs ({files}, "
        f"quality {VOC_QUALITY}, {sum(sizes) / len(sizes) / 1e3:.1f} kB each); read_jpeg "
        f"{', '.join(f'{ms:.1f}' for ms in decode_ms)} ms a background on the host CPU (median "
        f"{statistics.median(decode_ms):.1f}), {min(psnr):.1f}-{max(psnr):.1f} dB against the sources [{card}]")
    return {"decode_ms": decode_ms, "psnr": psnr}


class SubstitutionCount:
    """Each training sample's data_syn flag, whether make_train_sample
    should substitute its background (always for data_syn; else when the
    sample's first draw, read from a copy of its generator, falls below
    REPLACE_OBSERVED_BG_RATIO) and whether replace_background did, from
    wrappers installed while train_net runs (the loader's worker threads
    keep their own flag)."""

    def __init__(self):
        self.rows = []
        self.local = threading.local()

    @contextlib.contextmanager
    def installed(self):
        from deepim_tpu_torch.data import loader as loader_mod
        from deepim_tpu_torch.data.preprocess import VOCBackgrounds

        real_make, real_replace = loader_mod.make_train_sample, VOCBackgrounds.replace_background

        def replace(voc, im, mask, rng, cache=None):
            out = real_replace(voc, im, mask, rng, cache)
            self.local.fired = out is not im
            return out

        def make(rec, cfg, points, rng, nprng, voc=None, cache=None):
            probe = random.Random()
            probe.setstate(rng.getstate())
            syn = bool(rec.get("data_syn", False))
            expect = syn or probe.random() < cfg.TRAIN.REPLACE_OBSERVED_BG_RATIO
            self.local.fired = False
            out = real_make(rec, cfg, points, rng, nprng, voc, cache=cache)
            self.rows.append((syn, expect, self.local.fired))
            return out

        loader_mod.make_train_sample, VOCBackgrounds.replace_background = make, replace
        try:
            yield self
        finally:
            loader_mod.make_train_sample, VOCBackgrounds.replace_background = real_make, real_replace


def check_imported(label: str, model, source: dict, fresh: dict, export_path: str) -> None:
    """The network as train_net hands it to the train step: each layer of
    the file equal to its array under the mapping (encoder, decoder and
    flow layers as stored; flow_conv1's two image blocks reversed, BGR to
    RGB, and its two mask channels zero), every head equal to a fresh
    seeded build, and mxnet_from_state_dict of it, written and read back,
    equal to the file's arrays (flow_conv1's first 6 channels)."""
    from deepim_tpu_torch.models.import_mxnet import mxnet_from_state_dict
    from deepim_tpu_torch.utils.mxnet_io import load_mxnet_params, save_mxnet_params

    sd = {k: v.detach() for k, v in model.state_dict().items()}
    keys = {name: f"convs.{name}" if name.startswith(("flow_conv", "conv")) else name for name, *_ in FLOWNET_CONVS}
    keys.update({name: f"{name}.deconv" for name, *_ in FLOWNET_DECONVS})
    bad = []
    for name, key in keys.items():
        w, b = sd[f"{key}.weight"].cpu().numpy(), sd[f"{key}.bias"].cpu().numpy()
        want = source[f"{name}_weight"]
        if name == "flow_conv1":
            ok = np.array_equal(w[:, :6], want[:, [2, 1, 0, 5, 4, 3]]) and not w[:, 6:].any()
        else:
            ok = np.array_equal(w, want)
        if not ok or not np.array_equal(b, source[f"{name}_bias"]):
            bad.append(name)
    heads = [k for k in sd if k.rsplit(".", 1)[0] in HEAD_LAYERS]
    bad += [k for k in heads if not torch.equal(sd[k].cpu(), fresh[k])]
    if bad:
        raise AssertionError(f"{label}: the network before its first step differs from the import in {bad}")
    save_mxnet_params(export_path, mxnet_from_state_dict(sd, input_hw=(H, W)))
    back = load_mxnet_params(export_path)
    for k, v in source.items():
        got = back[k][:, :6] if k == "flow_conv1_weight" else back[k]
        if not np.array_equal(got, v):
            bad.append(k)
    if bad:
        raise AssertionError(f"{label}: the export of the initial network differs from the file in {bad}")
    log(f"[{label}] before the first step, on the card: {len(keys)} imported layers equal the file's arrays under "
        f"the mapping, {len(heads)} head tensors equal a fresh seeded build; the export read back equals the "
        f"file's {len(source)} arrays")


def native_parse(devkit: str, card: str) -> dict:
    """utils/native.py on the devkit's sphere: whether the library loaded,
    and the ms of points.xyz and textured.obj parses (native where it
    loaded, the Python parse beside it)."""
    from deepim_tpu_torch.render import mesh as mesh_mod
    from deepim_tpu_torch.utils import native

    model_dir = os.path.join(devkit, "models", "sphere")
    xyz, obj = os.path.join(model_dir, "points.xyz"), os.path.join(model_dir, "textured.obj")
    out = {"loaded": native.available()}
    for key, fn in (("xyz", lambda: native.load_points_xyz(xyz)), ("obj", lambda: mesh_mod.parse_obj(obj))):
        t0 = time.perf_counter()
        fn()
        out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3
    real = mesh_mod.parse_obj_native
    mesh_mod.parse_obj_native = lambda path: None
    try:
        t0 = time.perf_counter()
        python_obj = mesh_mod.parse_obj(obj)
        out["obj_python_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        mesh_mod.parse_obj_native = real
    if out["loaded"]:
        for a, b in zip(mesh_mod.parse_obj(obj), python_obj):
            if not np.array_equal(a, b):
                raise AssertionError("native OBJ parse differs from the Python parse on the sphere")
    log(f"[recipe] native mesh/points reader {'loaded' if out['loaded'] else 'NOT loaded (Python parse)'}: "
        f"points.xyz ({os.path.getsize(xyz) / 1e3:.0f} kB) {out['xyz_ms']:.2f} ms, textured.obj "
        f"({os.path.getsize(obj) / 1e3:.0f} kB) {out['obj_ms']:.2f} ms, the Python parse {out['obj_python_ms']:.2f} ms "
        f"[{card}]")
    return out


def recipe_config(devkit: str, params: str):
    """lm6d_ape_iter4_8epoch.yaml as written but for the paths (the devkit's
    sphere, its VOC pool), network.pretrained (the .params file), the
    background ratio and one epoch: 4 steps."""
    cfg = update_config_dict(load_config(EVAL_CFG), {
        "output_path": os.path.join(PHASE16_DIR, "output"),
        "dataset": {"dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": ["sphere"]},
        "network": {"pretrained": params},
        "TRAIN": {"REPLACE_OBSERVED_BG_RATIO": RECIPE_BG_RATIO, "end_epoch": 1},
    })
    return validate_config(cfg)


def drive_recipe(dev, card: str) -> dict:
    """Phase 16 (see the module docstring).  Returns csr_raster's check at
    the recipe's render with its launches (recipe_ keys)."""
    label = "recipe"
    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    devkit = os.path.join(PHASE16_DIR, "devkit")
    mesh = {"sphere": make_icosphere(0.05, 5)}
    bank = MeshBank.from_meshes([mesh["sphere"]]).arrays()
    raster = tune_raster_for_bank(EngineConfig(raster=RasterConfig(height=H, width=W)), bank, LINEMOD_K).raster
    generate_dataset(devkit, mesh, LINEMOD_K, n_train=RECIPE_PAIRS, n_val=0, height=H, width=W, raster_cfg=raster,
                     device=dev)
    voc = write_voc_pool(devkit, card)
    native = native_parse(devkit, card)
    params = os.path.join(PHASE16_DIR, "flownet-0000.params")
    t0 = time.perf_counter()
    source = write_flownet_params(params)
    n_params = sum(a.size for k, a in source.items() if k != "upsampling_weight")
    log(f"[{label}] vanilla FlowNetS checkpoint: {len(source)} arrays, {n_params / 1e6:.2f} M parameters, "
        f"{os.path.getsize(params) / 1e6:.1f} MB, written in {time.perf_counter() - t0:.2f} s")
    cfg = recipe_config(devkit, params)
    b, n_inner = cfg.TRAIN.BATCH_PAIRS, cfg.network.TRAIN_ITER_SIZE
    steps = 2 * RECIPE_PAIRS // b

    # One render's plan at the recipe's batch, and csr_raster against its twin there.
    ecfg = EngineConfig.from_config(cfg, train=True, bank_arrays=build_mesh_bank(cfg))
    _, recs = load_gt_pairdb(cfg, "LM6D_REFINE", "train_sphere", "sphere", devkit, devkit)
    m = MeshBuffers.gather(build_mesh_bank(cfg), np.zeros(b, np.int64), device=dev)
    plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                         torch.from_numpy(np.stack([r["pose_rendered"] for r in recs[:b]])),
                         torch.from_numpy(cfg.dataset.intrinsic_matrix()), ecfg.raster, corners=m.corners,
                         corner_colors=m.corner_colors, device=dev)
    if {name for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"{label}: a render plans {[name for name, _ in plan]}")
    kernel = check_kernel("csr_raster", plan[0][1], card, shape=label)
    del kernel["out"]

    fresh = build_model(cfg, device="cpu").state_dict()
    seen, init_ms = {}, []
    real_init, real_dp = train_net_mod.init_pretrained, train_net_mod.train_step_dp

    def timed_init(c, model):
        t0 = time.perf_counter()
        real_init(c, model)
        torch.cuda.synchronize()
        init_ms.append((time.perf_counter() - t0) * 1e3)

    def first_step_check(step, mesh_, state, unused):
        check_imported(label, state.model, source, fresh, os.path.join(PHASE16_DIR, "export.params"))
        seen.update({k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()})
        return real_dp(step, mesh_, state, unused)

    subs = SubstitutionCount()
    train_net_mod.init_pretrained, train_net_mod.train_step_dp = timed_init, first_step_check
    try:
        with subs.installed():
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            t0 = time.perf_counter()
            state = train_net(cfg, output_dir=os.path.join(PHASE16_DIR, "train"), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        train_net_mod.init_pretrained, train_net_mod.train_step_dp = real_init, real_dp
    if not seen or len(init_ms) != 1:
        raise AssertionError(f"{label}: init_pretrained ran {len(init_ms)} times; the first-step check ran: "
                             f"{bool(seen)}")
    expect = len(plan) * n_inner * steps
    if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"{label}: launches {counts}, want csr_raster {expect} ({len(plan)} a render x {n_inner} "
                             f"inner iterations x {steps} steps) and nothing else")
    syn = [r for r in subs.rows if r[0]]
    real = [r for r in subs.rows if not r[0]]
    if len(subs.rows) != steps * b or any(e != f for _, e, f in subs.rows) or not syn or not all(f for *_, f in syn):
        raise AssertionError(f"{label}: substitutions (data_syn, expected, fired) {subs.rows}")
    e = state.epochs[0]
    if e["nonfinite_losses"] or e["raster_dropped"]:
        raise AssertionError(f"{label}: {e['nonfinite_losses']} non-finite loss values, {e['raster_dropped']} dropped "
                             "face-tile pairs")
    params_now = state.model.state_dict()
    still = [k for k, v in seen.items() if torch.equal(v, params_now[k].cpu())]
    if still or state.step != steps * n_inner:
        raise AssertionError(f"{label}: {state.step} updates; parameters not moved {still}")
    losses = {k: v for k, v in e["metrics"].items() if k.endswith("loss")}
    log(f"[{label}] train_net on {os.path.basename(EVAL_CFG)} as written (sphere devkit, VOC pool, network.pretrained "
        f"= the .params file, REPLACE_OBSERVED_BG_RATIO {RECIPE_BG_RATIO}, 1 epoch): {steps} steps of {b} pairs x "
        f"{n_inner} inner iterations at {H}x{W} in {e['loop_s']:.3f} s, {e['loop_s'] / steps:.3f} s a step, "
        f"{e['samples'] / e['loop_s']:.2f} samples/s (no warm-up call in this phase: cold when it runs alone); "
        f"init_pretrained {init_ms[0]:.1f} ms (read, import, load onto the card); train_net {wall:.3f} s in all "
        f"[{card}]")
    log(f"[{label}] substitutions: all {len(syn)} data_syn samples and {sum(f for *_, f in real)} of {len(real)} real "
        f"ones (each as its draw decided); every loss finite ("
        + ", ".join(f"{k} {float(v[0, -1]):.4g} -> {float(v[-1, -1]):.4g}" for k, v in sorted(losses.items()))
        + f"), every parameter updated, launches {counts}; phase 16 {time.perf_counter() - t_phase:.1f} s [{card}]")
    for path in (params, os.path.join(PHASE16_DIR, "export.params")):
        os.remove(path)
    kernel["launches"] = counts["csr_raster"]
    return {"csr_raster": {"recipe": kernel}}


# Phase 17: the module tail at full width (files under a gitignored directory).
PHASE17_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase17")
SE3_B = 8             # frames of (A): make_mixed_detail_mesh posed at LINEMOD depths
SE3_SEED = 17
SE3_ROT_DEG = 0.5     # (A): recovered relative rotation against the truth
SE3_TRANS_M = 5e-3    # and translation
METRIC_PAIRS = 256    # (B): pose pairs on the mesh's vertices
METRIC_CPU_ADI = 16   # (B): of them, the pairs whose adi is also run on the CPU (O(N^2) a pair)
METRIC_CPU_RTOL = 1e-5
METRIC_HOST_RTOL = 1e-4
METRIC_RE_ATOL = 1e-3  # degrees: float32's arccos resolves no finer near 0
DILATE_B = 16         # (C): masks a call
VISIB_DELTA = 0.015   # (D): metres, the BOP toolkit's default


def se3_poses(n: int, rng) -> tuple:
    """n target poses B (uniform rotations, x and y within 5 cm, z 0.6-1.0
    m, LINEMOD's range) and their sources A, perturbed as synth_data
    perturbs an initial pose; float32 (n, 3, 4) each."""
    from scipy.spatial.transform import Rotation

    rot = Rotation.random(n, random_state=rng).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.6, 1.0, n)], 1)
    pose_b = np.concatenate([rot, t[:, :, None]], 2).astype(np.float32)
    pose_a = np.stack([sample_perturbed_pose(p, rng) for p in pose_b]).astype(np.float32)
    return pose_a, pose_b


def quat_deg(q1: np.ndarray, q2: np.ndarray) -> float:
    return float(np.degrees(2 * np.arccos(min(abs(float(np.dot(q1, q2))), 1.0))))


def drive_flow2se3(dev, card: str) -> tuple:
    """Phase 17A: renders at A and B, flow on the card, flow2se3 on the
    host a frame.  Returns (csr_raster's check at B's render with the
    launches, the renders and flow on the host)."""
    label = "flow2se3"
    rng = np.random.RandomState(SE3_SEED)
    mesh = make_mixed_detail_mesh(0)
    bank = MeshBank.from_meshes([mesh]).arrays()
    ecfg = EngineConfig(height=H, width=W, raster=RasterConfig(height=H, width=W))
    ecfg = tune_raster_for_bank(ecfg, bank, LINEMOD_K)
    m = MeshBuffers.gather(bank, np.zeros(SE3_B, np.int64), device=dev)
    k = torch.from_numpy(LINEMOD_K).to(dev)
    pose_a, pose_b = (torch.from_numpy(p).to(dev) for p in se3_poses(SE3_B, rng))
    plans = [kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, p, k, ecfg.raster, corners=m.corners,
                           corner_colors=m.corner_colors, device=dev) for p in (pose_a, pose_b)]
    if {name for plan in plans for name, _ in plan} != {"csr_raster"}:
        raise AssertionError(f"{label}: the renders plan {[[n for n, _ in plan] for plan in plans]}")
    kernel = check_kernel("csr_raster", plans[1][0][1], card, shape=label)
    ref = PLAIN["csr_raster"](*plans[1][0][1])
    if not torch.equal(kernel.pop("out"), ref):
        raise AssertionError(f"{label}: csr_raster differs from its twin at the render of B")

    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    img_a, depth_a, mask_a = render_at_pose(m, pose_a, k, ecfg, device=dev)
    img_b, depth_b, mask_b = render_at_pose(m, pose_b, k, ecfg, device=dev)
    flow, valid = flow_from_depth(depth_a[:, 0], depth_b[:, 0], pose_a, pose_b, k, standard_rep=True)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    counts = launch_counts()
    expect = len(plans[0]) + len(plans[1])
    if counts != {"csr_raster": expect, "csr_planes_raster": 0, "tile_raster": 0}:
        raise AssertionError(f"{label}: launches {counts}, want csr_raster {expect} (two renders) and nothing else")

    host = {"img_a": img_a.cpu().numpy(), "img_b": img_b.cpu().numpy(), "depth_a": depth_a[:, 0].cpu().numpy(),
            "depth_b": depth_b[:, 0].cpu().numpy(), "flow": flow.cpu().numpy(), "valid": valid.cpu().numpy(),
            "masks": torch.cat([mask_a, mask_b])[:, 0]}
    rel = se3_mul(pose_b, se3_inverse(pose_a)).cpu().double()
    q_true = mat2quat(rel[:, :, :3]).numpy()
    k64 = LINEMOD_K.astype(np.float64)
    ms, rows = [], []
    for j in range(SE3_B):
        depth, fl, mask = host["depth_a"][j], host["flow"][j].transpose(1, 2, 0), host["valid"][j]
        t0 = time.perf_counter()
        ok, se3_q = flow2se3(depth, fl, mask, k64, rng=j)
        ms.append((time.perf_counter() - t0) * 1e3)
        obj, img = flow_correspondences(depth, fl, mask, k64)
        r, t, inliers = pnp_ransac(obj, img, k64, rng=j)
        rot_err = quat_deg(se3_q[:4], q_true[j])
        trans_err = float(np.abs(se3_q[4:] - rel[j, :, 3].numpy()).max())
        rows.append((len(obj), int(inliers.sum()), rot_err, trans_err))
        if not ok or rot_err > SE3_ROT_DEG or trans_err > SE3_TRANS_M or not np.array_equal(t, se3_q[4:]):
            raise AssertionError(f"{label}: frame {j}: converged {ok}, rotation {rot_err} deg, translation "
                                 f"{trans_err} m from se3_mul(B, se3_inverse(A)); {rows[-1][:2]} points, inliers")
    log(f"[{label}] {SE3_B} frames of make_mixed_detail_mesh ({mesh.num_faces} faces) at {H}x{W}, A perturbed from B "
        f"as synth_data perturbs: renders and flow_from_depth on the card {render_s:.3f} s, csr_raster launches "
        f"{counts['csr_raster']} (planned {expect}); flow2se3 on the host "
        f"{statistics.median(ms):.1f} ms a frame (median; frames {[round(x, 1) for x in ms]}); valid points "
        f"{[r[0] for r in rows]}, inliers {[r[1] for r in rows]}; worst error against se3_mul(B, se3_inverse(A)) "
        f"{max(r[2] for r in rows):.2e} deg, {max(r[3] for r in rows) * 1e3:.2e} mm [{card}]")
    kernel["launches"] = counts["csr_raster"]
    return kernel, host


def drive_pose_metrics(dev, card: str) -> None:
    """Phase 17B: add, adi, re, te, arp_2d of METRIC_PAIRS pose pairs on the
    card against the CPU (float32) and the evaluator's float64 functions."""
    label = "pose metrics"
    rng = np.random.RandomState(SE3_SEED + 1)
    pts = make_mixed_detail_mesh(0).vertices.astype(np.float32)
    est, gt = se3_poses(METRIC_PAIRS, rng)
    args = {"add": ("r_e", "t_e", "r_g", "t_g", "pts"), "adi": ("r_e", "t_e", "r_g", "t_g", "pts"),
            "re": ("r_e", "r_g"), "te": ("t_e", "t_g"), "arp_2d": ("r_e", "t_e", "r_g", "t_g", "pts", "k")}
    inputs = {"r_e": est[:, :, :3], "t_e": est[:, :, 3], "r_g": gt[:, :, :3], "t_g": gt[:, :, 3], "pts": pts,
              "k": LINEMOD_K}
    on = {d: {n: torch.from_numpy(np.ascontiguousarray(v)).to(d) for n, v in inputs.items()} for d in (dev, "cpu")}

    def call(name, d, sl=slice(None)):
        return getattr(pose_metrics, name)(*(on[d][a][sl] if a not in ("pts", "k") else on[d][a]
                                             for a in args[name]))

    card_out = {name: call(name, dev) for name in args}
    card_ms = {name: cuda_ms(lambda name=name: call(name, dev), reps=3, warmup=1) for name in args}
    p64, e64, g64 = pts.astype(np.float64), est.astype(np.float64), gt.astype(np.float64)
    host_fns = {"add": lambda: evaluator._add_errors(e64, g64, p64),
                "adi": lambda: evaluator._adi_errors(e64, g64, p64),
                "re": lambda: evaluator._rot_trans_errors(e64, g64)[0],
                "te": lambda: evaluator._rot_trans_errors(e64, g64)[1],
                "arp_2d": lambda: evaluator._arp2d_errors(e64, g64, p64, LINEMOD_K.astype(np.float64))}
    host_ms, report = {}, []
    for name in args:
        t0 = time.perf_counter()
        host = host_fns[name]()
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        got = card_out[name].cpu().numpy()
        sl = slice(0, METRIC_CPU_ADI) if name == "adi" else slice(None)
        cpu = call(name, "cpu", sl).numpy()
        cpu_err = float(np.max(np.abs(got[sl] - cpu) / np.abs(cpu)))
        host_err = float(np.max(np.abs(got - host) / np.abs(host)))
        atol = METRIC_RE_ATOL if name == "re" else 0.0
        if not (np.isfinite(got).all() and np.allclose(got[sl], cpu, rtol=METRIC_CPU_RTOL, atol=atol)
                and np.allclose(got, host, rtol=METRIC_HOST_RTOL, atol=atol)):
            raise AssertionError(f"{label}: {name} on the card against the CPU {cpu_err:.3g}, against the "
                                 f"evaluator {host_err:.3g} (relative)")
        report.append(f"{name} {card_ms[name]:.3f} ms on the card vs {host_ms[name]:.1f} ms evaluator (rel. err "
                      f"CPU {cpu_err:.1e}, evaluator {host_err:.1e})")
    log(f"[{label}] {METRIC_PAIRS} pairs, {len(pts)} model points (adi's CPU run on the first {METRIC_CPU_ADI}): "
        + "; ".join(report) + f" [{card}]")


def drive_tail_utils(dev, card: str, host: dict) -> None:
    """Phase 17C-E: mask_dilate_random, the visibility masks and
    visualize_minibatch on (A)'s renders."""
    masks = host["masks"][:DILATE_B].float()
    out = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        out[d] = mask_dilate_random(masks.to(d), torch.Generator().manual_seed(SE3_SEED))
        if d != "cpu":
            torch.cuda.synchronize()
        out[d, "ms"] = (time.perf_counter() - t0) * 1e3
    card_ms = cuda_ms(lambda: mask_dilate_random(masks.to(dev), torch.Generator().manual_seed(SE3_SEED)), reps=5)
    grown = int((out["cpu"] > masks.cpu()).sum())
    if not torch.equal(out[dev].cpu(), out["cpu"]) or not grown:
        raise AssertionError(f"mask_dilate_random: card and CPU differ in {int((out[dev].cpu() != out['cpu']).sum())} "
                             f"px ({grown} px grown)")
    log(f"[mask dilation] mask_dilate_random on {DILATE_B} masks of {H}x{W}: card equals CPU from one seed, "
        f"{grown} px grown; {card_ms:.3f} ms a call on the card (first call {out[dev, 'ms']:.1f} ms), "
        f"{out['cpu', 'ms']:.1f} ms on the CPU [{card}]")

    d_test, d_est = (torch.from_numpy(host[n]) for n in ("depth_b", "depth_a"))
    visib = {}
    for d in (dev, "cpu"):
        gt = estimate_visib_mask_gt(d_test.to(d), d_test.to(d), VISIB_DELTA)
        visib[d] = (estimate_visib_mask(d_test.to(d), d_est.to(d), VISIB_DELTA), gt,
                    estimate_visib_mask_est(d_test.to(d), d_est.to(d), gt, VISIB_DELTA))
    if any(not torch.equal(a.cpu(), b) for a, b in zip(visib[dev], visib["cpu"])):
        raise AssertionError("visibility masks: card and CPU differ")
    log(f"[visibility] estimate_visib_mask, _gt, _est on (A)'s depths (test = B's render, est = A's, delta "
        f"{VISIB_DELTA} m): card equals CPU; visible px {[int(v.sum()) for v in visib['cpu']]} [{card}]")

    path = os.path.join(PHASE17_DIR, "minibatch.png")
    t0 = time.perf_counter()
    visualize_minibatch(path, {"rendered": host["img_a"], "observed": host["img_b"]}, flow=host["flow"])
    vis_s = time.perf_counter() - t0
    shape = read_png(path).shape
    if shape != (2 * H, 3 * W, 3):
        raise AssertionError(f"visualize_minibatch wrote a {shape} grid")
    log(f"[visualize_minibatch] {shape} grid (rendered | observed | flow, 2 samples) in {vis_s:.3f} s, "
        f"{os.path.getsize(path)} bytes of PNG [{card}]")


def drive_phase17(dev, card: str) -> dict:
    """Phase 17 (see the module docstring).  Returns csr_raster's check at
    (A)'s render of B with its launches (flow2se3_ keys); (B)-(E) launch
    no raster kernel."""
    shutil.rmtree(PHASE17_DIR, ignore_errors=True)
    os.makedirs(PHASE17_DIR)
    kernel, host = drive_flow2se3(dev, card)
    before = launch_counts()
    drive_pose_metrics(dev, card)
    drive_tail_utils(dev, card, host)
    if launch_counts() != before:
        raise AssertionError(f"phase 17 (B)-(E) launched raster kernels: {before} -> {launch_counts()}")
    return {"csr_raster": {"flow2se3": kernel}}


# Phase 18: learned closed-loop tracking (tools/track_learned.py), the
# tracking fine-tune (tools/track_finetune.py) and its noise-mix devkit,
# at the 256x256 protocol's width, cut in depth.
PHASE18_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase18")
P18_SIZE = 256        # the 256^2 protocol's frame
P18_CLASSES = 4       # benchmark classes (1,280 faces: tile_raster), and the tracked videos
P18_PAIRS = 8         # training pairs a class in both devkits (cut from 256)
P18_BATCH = 32        # the protocol's batch: one step an epoch here (bench_render_check renders as many)
P18_VAL = 2           # the benchmark devkit's test pairs a class (cut from 32; --train-only tests none)
P18_FT_VAL = 16       # track_finetune's test pairs a class (its generate_dataset call's n_val)
P18_EPOCHS = 2        # benchmark_multiclass epochs (cut from 60), then one fine-tune epoch (cut from 20)
P18_FRAMES = 8        # tracked frames (cut from 60)
P18_ITERS, P18_INIT = 2, 4  # iterations a frame and lock-on iterations (track_learned_r4's second variant)


def tile_counted(label: str, fn, expect: int) -> tuple:
    """fn() with the launch counters zeroed just before and read just
    after: tile_raster exactly `expect` times and nothing else.  Returns
    (fn's result, its wall seconds)."""
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if counts != {"csr_raster": 0, "csr_planes_raster": 0, "tile_raster": expect}:
        raise AssertionError(f"{label}: launches {counts}, want tile_raster {expect} and nothing else")
    return out, wall


def drive_phase18(dev, card: str) -> dict:
    """Phase 18 (see the module docstring).  Returns tile_raster's checks
    at the track's render and at the fine-tune's training render, each
    with its run's launches."""
    from deepim_tpu_torch.engine.tracker import make_tracker
    from deepim_tpu_torch.tools import benchmark_multiclass, track_finetune, track_learned

    shutil.rmtree(PHASE18_DIR, ignore_errors=True)
    devkit = os.path.join(PHASE18_DIR, "bench")
    c = P18_CLASSES
    common = ["--size", str(P18_SIZE), "--classes", str(c), "--subdiv", "3", "--device", str(dev)]
    steps = c * P18_PAIRS // P18_BATCH

    # (A) the benchmark checkpoint the fine-tune and the track start from:
    # each pair's gt and initial pose rendered once, one render an inner
    # iteration of a training step.
    argv = [*common, "--batch", str(P18_BATCH), "--n-train", str(P18_PAIRS), "--n-val", str(P18_VAL), "--epochs",
            str(P18_EPOCHS),
            "--train-iter-size", "2", "--lr", "2e-4", "--train-only", "--out", devkit]
    expect = c * (P18_PAIRS + P18_VAL) * 2 + P18_EPOCHS * steps * 2
    _, wall = tile_counted("benchmark_multiclass", lambda: benchmark_multiclass.main(argv), expect)
    log(f"[phase 18 benchmark_multiclass] {' '.join(argv)}: {wall:.3f} s, tile_raster {expect} launches [{card}]")

    # (B) the fine-tune: its noise-mix devkit, the seed copy, one epoch.
    ft_argv = [*common, "--batch", str(P18_BATCH), "--epochs", str(P18_EPOCHS), "--finetune-epochs", "1",
               "--n-train", str(P18_PAIRS), "--devkit", devkit]
    expect_ft = c * (P18_PAIRS + P18_FT_VAL) * 2 + steps * 2
    state, wall = tile_counted("track_finetune", lambda: track_finetune.main(ft_argv), expect_ft)
    e = state.epochs[0]
    if (len(state.epochs) != 1 or e["epoch"] != P18_EPOCHS + 1 or e["nonfinite_losses"] or e["raster_dropped"]
            or not np.isfinite(e["metrics"]["total"]).all()):
        raise AssertionError(f"track_finetune: epochs {[x['epoch'] for x in state.epochs]}, want {P18_EPOCHS + 1}; "
                             f"{e['nonfinite_losses']} non-finite loss values, {e['raster_dropped']} dropped pairs")
    ft_args = track_finetune.parse_args(ft_argv)
    ft_devkit = devkit + "_trackft"
    classes = sorted(benchmark_multiclass.make_benchmark_classes(c, 3))
    k = benchmark_multiclass.benchmark_k(P18_SIZE, P18_SIZE)
    ft_cfg = track_finetune.finetune_config(ft_args, ft_devkit, classes, k)
    rot_deg = []  # the initial poses' rotation errors in the noise-mix devkit
    for cls in classes:
        for rec in load_gt_pairdb(ft_cfg, "LM6D_REFINE", "train_" + cls, cls, ft_devkit, ft_devkit)[1]:
            cos = (np.trace(rec["pose_rendered"][:, :3] @ rec["pose_observed"][:, :3].T) - 1) / 2
            rot_deg.append(float(np.degrees(np.arccos(np.clip(cos, -1, 1)))))
    train_check = bench_render_check(ft_cfg, True, "train_", dev, card,
                                     f"trackft train ({P18_SIZE}x{P18_SIZE}, batch {P18_BATCH})")
    train_check["launches"] = expect_ft
    log(f"[phase 18 track_finetune] {' '.join(ft_argv)}: {wall:.3f} s; resumed at epoch {P18_EPOCHS} from the "
        f"seed copy; epoch {e['epoch']}: {e['samples']} samples, {e['samples'] / e['loop_s']:.2f} samples/s, mean "
        f"loss {float(e['metrics']['total'].mean()):.4f}; noise-mix devkit: initial rotation error median "
        f"{np.median(rot_deg):.2f} deg, {np.mean(np.asarray(rot_deg) < 15.0):.2f} of pairs under 15 deg; "
        f"tile_raster {expect_ft} launches [{card}]")

    # (C) the learned track from the fine-tuned checkpoint: the observed
    # frames (one render a frame), the lock-on and each frame's iterations.
    run_dir = os.path.join(ft_devkit, "run")
    end = P18_EPOCHS + 1
    tl_argv = [*common, "--track-classes", str(c), "--frames", str(P18_FRAMES), "--epochs", str(end),
               "--prefix", track_finetune.FT_PREFIX, "--run-dir", run_dir, "--iters-per-frame", str(P18_ITERS),
               "--init-iters", str(P18_INIT)]
    expect_t = P18_FRAMES + P18_INIT + P18_FRAMES * P18_ITERS
    res, wall = tile_counted("track_learned", lambda: track_learned.main(tl_argv), expect_t)
    summary, run = res["summary"], res["run"]
    numbers = [summary["mean_add_over_d"]] + [v for r in summary["per_class"] for v in r.values()
                                               if not isinstance(v, str)]
    poses = res["poses_est"]
    r = poses[..., :3]
    orth = float(np.abs(r @ np.swapaxes(r, -1, -2) - np.eye(3)).max())
    if (poses.shape != (P18_FRAMES, c, 3, 4) or not np.isfinite(poses).all() or orth > 1e-3
            or not np.isfinite(numbers).all() or run["raster_dropped"] or len(summary["per_class"]) != c):
        raise AssertionError(f"track_learned: poses {poses.shape}, orthonormality err {orth}, summary {summary}, "
                             f"dropped {run['raster_dropped']}")
    log(f"[phase 18 track_learned] {' '.join(tl_argv)}: {wall:.3f} s; {run['frames_per_s']:.2f} tracked frames/s "
        f"({c} videos a frame, {run['track_s']:.3f} s for the track), observed renders {run['render_s']:.3f} s; "
        f"tile_raster {expect_t} launches ({P18_FRAMES} observed + {P18_INIT} lock-on + {P18_FRAMES} x {P18_ITERS}); "
        f"0 dropped pairs [{card}]")

    # The track's render against its twin, and one track under the profiler.
    meshes_by_name = benchmark_multiclass.make_benchmark_classes(c, 3)
    bank = MeshBank.from_meshes([meshes_by_name[cl] for cl in classes]).arrays()
    m = MeshBuffers.gather(bank, np.arange(c), device=dev)
    ecfg = track_learned.tracking_engine(P18_SIZE, P18_SIZE, P18_ITERS, bank, k)
    plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(res["poses_gt"][0]),
                         torch.from_numpy(k), ecfg.raster, corners=m.corners, corner_colors=m.corner_colors,
                         device=dev)
    if [name for name, _ in plan] != ["tile_raster"]:
        raise AssertionError(f"track_learned: a render plans {[name for name, _ in plan]}")
    track_check = check_kernel("tile_raster", plan[0][1], card,
                               shape=f"track_learned ({P18_SIZE}x{P18_SIZE}, batch {c})")
    if track_check["max_abs_err"] != 0.0 or train_check["max_abs_err"] != 0.0:
        raise AssertionError(f"tile_raster differs from its twin: track {track_check['max_abs_err']}, "
                             f"fine-tune {train_check['max_abs_err']}")
    del track_check["out"]
    track_check["launches"] = expect_t
    model = track_learned.load_tracking_model(run_dir, track_finetune.FT_PREFIX, end, P18_SIZE, P18_SIZE, device=dev)
    track = make_tracker(model, ecfg, P18_ITERS, init_iters=P18_INIT, device=dev)
    frames = torch.from_numpy(res["frames"]).to(dev)
    args = (m, torch.from_numpy(k).to(dev), torch.from_numpy(res["pose0"]).to(dev))
    with torch.no_grad():
        fam = breakdown(f"track_learned {P18_FRAMES} frames", lambda: track(frames, *args), card)
    log(f"[phase 18 track_learned] one {P18_FRAMES}-frame track ({c} videos, {P18_INIT} lock-on iterations): device "
        f"busy {fam['busy']:.2f} of {fam['wall']:.2f} ms wall, idle share {1 - fam['busy'] / fam['wall']:.3f}, "
        f"{fam['wall'] / P18_FRAMES:.2f} ms a frame under the profiler [{card}]")
    return {"tile_raster": {"track_learned": track_check, "trackft_train": train_check}}


# Phase 19: A1's chained 480x640 run (a 256x256 base seeding a 480x640 run
# through --seed-convs, as tools/a1_protocol.sh chains them), the learning
# check and the .params resume check, cut in depth.
PHASE19_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase19")
P19_CLASSES = 4       # benchmark classes (1,280 faces: tile_raster)
P19_BASE_SIZE = 256   # the base's frame
P19_HW = (480, 640)   # the seeded run's frame
P19_BASE_PAIRS = 8    # the 256x256 base's training pairs a class (cut from 256): one step of batch 32
P19_PAIRS = 8         # the 480x640 run's training pairs a class (cut from 128): two steps of batch 16
P19_VAL = 4           # its test pairs a class (cut from 32): one test batch of 16
P19_BATCH = 16        # the 480x640 protocol's batch, training and test
P19_ITER_SIZE = 4     # its TRAIN_ITER_SIZE
SANITY_SIZE, SANITY_TRAIN, SANITY_VAL = 128, 32, 8  # synthetic_sanity's frame and pairs a class (from 512 / 64)
PARITY_SIZE, PARITY_TRAIN, PARITY_VAL = 64, 32, 8  # params_resume_parity's defaults: 8 steps of batch 8


def drive_phase19(dev, card: str) -> dict:
    """Phase 19 (see the module docstring).  Returns tile_raster's checks
    at the 480x640 run's training and test renders, each with the run's
    launches."""
    from deepim_tpu_torch.engine.checkpoint import read_checkpoint
    from deepim_tpu_torch.tools import benchmark_multiclass, params_resume_parity, synthetic_sanity

    shutil.rmtree(PHASE19_DIR, ignore_errors=True)
    c = P19_CLASSES
    base, hires = os.path.join(PHASE19_DIR, "base_256"), os.path.join(PHASE19_DIR, "hires_480x640")
    common = ["--classes", str(c), "--subdiv", "3", "--device", str(dev)]

    # (A) the 256x256 base: each pair's gt and initial pose rendered once,
    # one render an inner iteration of its one step.
    argv = [*common, "--size", str(P19_BASE_SIZE), "--batch", "32", "--n-train", str(P19_BASE_PAIRS), "--n-val", "1",
            "--epochs", "1", "--train-iter-size", "2", "--lr", "2e-4", "--train-only", "--out", base]
    expect = c * (P19_BASE_PAIRS + 1) * 2 + (c * P19_BASE_PAIRS // 32) * 2
    _, wall = tile_counted("benchmark_multiclass 256x256 base", lambda: benchmark_multiclass.main(argv), expect)
    log(f"[phase 19 base] {' '.join(argv)}: {wall:.3f} s, tile_raster {expect} launches [{card}]")

    # (B) the 480x640 run seeded from it, trained and tested; train_net's
    # initial weights are caught on their way in.
    seen = {}
    real_train_net = benchmark_multiclass.train_net

    def catching(cfg, output_dir=None, device="cuda", init_state_dict=None):
        seen["init"] = init_state_dict
        return real_train_net(cfg, output_dir=output_dir, device=device, init_state_dict=init_state_dict)

    hi_argv = [*common, "--size", str(P19_HW[0]), "--width", str(P19_HW[1]), "--batch", str(P19_BATCH), "--train-iter-size",
               str(P19_ITER_SIZE), "--lr", "1e-4", "--n-train", str(P19_PAIRS), "--n-val", str(P19_VAL),
               "--epochs", "1", "--seed-convs", os.path.join(base, "run", benchmark_multiclass.PREFIX),
               "--seed-epoch", "1", "--out", hires]
    evals = 2 * TEST_ITERS  # pred_eval's refine and eval_flow_epe each render once an iteration
    expect_hi = (c * (P19_PAIRS + P19_VAL) * 2 + (c * P19_PAIRS // P19_BATCH) * P19_ITER_SIZE
                 + c * -(-P19_VAL // P19_BATCH) * evals)
    benchmark_multiclass.train_net = catching
    try:
        run_bench("benchmark_multiclass 480x640 seeded", benchmark_multiclass.main, hi_argv, expect_hi, c * P19_VAL,
                  card)
    finally:
        benchmark_multiclass.train_net = real_train_net
    saved = read_checkpoint(os.path.join(base, "run", benchmark_multiclass.PREFIX), 1)["model"]
    args = benchmark_multiclass.parse_args(hi_argv)
    classes = sorted(benchmark_multiclass.make_benchmark_classes(c, 3))
    cfg = benchmark_multiclass.benchmark_config(args, hires, classes, benchmark_multiclass.benchmark_k(*P19_HW))
    fresh = build_model(cfg, device="cpu").state_dict()
    init = seen["init"]
    seeded = [k for k in init if k in saved and saved[k].shape == init[k].shape]
    differ = [k for k in seeded if not torch.equal(init[k], saved[k])]
    kept = sorted(set(init) - set(seeded))
    if differ or kept != ["fc6.weight"] or not torch.equal(init["fc6.weight"], fresh["fc6.weight"]):
        raise AssertionError(f"seeded 480x640 run: {differ} differ from the base checkpoint; kept fresh {kept}; "
                             f"fc6.weight equal to the fresh draw: {torch.equal(init['fc6.weight'], fresh['fc6.weight'])}")
    log(f"[phase 19 seeded] {len(seeded)} of {len(init)} tensors equal to the 256x256 checkpoint's bit for bit; "
        f"fc6.weight {tuple(init['fc6.weight'].shape)} (base {tuple(saved['fc6.weight'].shape)}) equal to the fresh "
        f"draw [{card}]")
    checks = {}
    for tag, train, image_set in (("a1_480x640_train", True, "train_"), ("a1_480x640_test", False, "val_")):
        checks[tag] = bench_render_check(cfg, train, image_set, dev, card,
                                         f"{tag} (480x640, batch {P19_BATCH})", batch=P19_BATCH)
        checks[tag]["launches"] = expect_hi

    # (C) synthetic_sanity: the cube (12 faces) and the 320-face sphere.
    s_argv = ["--size", str(SANITY_SIZE), "--epochs", "1", "--n-train", str(SANITY_TRAIN), "--n-val",
              str(SANITY_VAL), "--out", os.path.join(PHASE19_DIR, "sanity"), "--device", str(dev)]
    expect_s = 2 * (SANITY_TRAIN + SANITY_VAL) * 2 + (2 * SANITY_TRAIN // 16) * 2 + 2 * -(-SANITY_VAL // 16) * evals
    out, wall = tile_counted("synthetic_sanity", lambda: synthetic_sanity.main(s_argv), expect_s)
    e, = out["epochs"]
    rows = out["classes"]
    numbers = [v for r in rows.values() for v in (r["init_acc"], r["init_mean"], *r["acc"], *r["mean"])]
    if (e["nonfinite_losses"] or e["raster_dropped"] or not np.isfinite(e["metrics"]["total"]).all()
            or not np.isfinite(numbers).all() or out["results"]["run"]["raster_dropped"]):
        raise AssertionError(f"synthetic_sanity: {e['nonfinite_losses']} non-finite losses, dropped "
                             f"{e['raster_dropped']}, table {rows}")
    log(f"[phase 19 synthetic_sanity] {' '.join(s_argv)}: {wall:.3f} s; mean loss {float(e['metrics']['total'].mean()):.4f}; "
        + "; ".join(f"{cls} ADD<0.1d init {r['init_acc']:.1f}% -> {[round(a, 1) for a in r['acc']]}, mean ADD "
                    f"{r['init_mean']:.4f} -> {[round(m, 4) for m in r['mean']]} m" for cls, r in rows.items())
        + f"; tile_raster {expect_s} launches [{card}]")

    # (D) params_resume_parity: the seed run, the export, both continuations.
    p_argv = ["--size", str(PARITY_SIZE), "--n-train", str(PARITY_TRAIN), "--n-val", str(PARITY_VAL), "--out",
              os.path.join(PHASE19_DIR, "interop"), "--device", str(dev)]
    steps = 2 * PARITY_TRAIN // 8 * 2  # an epoch's renders: TRAIN_ITER_SIZE 2
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    res = params_resume_parity.main(p_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_p = 2 * (PARITY_TRAIN + PARITY_VAL) * 2 + steps * (2 + 2)
    counts = launch_counts()
    if counts != {"csr_raster": 0, "csr_planes_raster": 0, "tile_raster": expect_p}:
        raise AssertionError(f"params_resume_parity: launches {counts}, want tile_raster {expect_p} and nothing else")
    if not res["ok"]:
        raise AssertionError(f"params_resume_parity: {res}")
    log(f"[phase 19 params_resume_parity] {' '.join(p_argv)}: {wall:.3f} s under torch.use_deterministic_algorithms; "
        f".params vs .npz resume {res['max_abs_diff_params_vs_npz_resume']}, drift from the seed "
        f"{res['max_abs_drift_from_seed']:.4g}; tile_raster {expect_p} launches [{card}]")
    return {"tile_raster": checks}


# Phase 20: the image readers (utils/imread.py) through both drivers at
# full width, on a devkit and its re-encoded twin (files under a gitignored
# directory).

PHASE20_DIR = os.path.join(ROOT, "deepim_tpu_torch", "_build", "phase20")
P20_TRAIN = 4         # training pairs a class, read as LM6D_REFINE and LM6D_REFINE_SYN: 2 steps of batch 4
P20_VAL = 4           # test pairs a class: one batch of 16, padded
P20_VOC = (((375, 500), "420", 0), ((333, 500), "444", 4))  # VOC pool: (h, w), chroma sampling, restart interval
P20_COLOR = ("jpeg", "palette", "rgb16", "adam7")  # twin encodings, cycled over the observed colour files
P20_SEED = 20
P20_KERNEL = {"cube": "tile_raster", "sphere": "csr_raster"}  # each class alone in its bank


def png_file(samples: np.ndarray, ctype: int, depth: int, palette=None, trns: bytes | None = None,
             interlace: bool = False) -> bytes:
    """A PNG of (h, w, channels) samples at 8 or 16 bits (colour type
    `ctype`, Sub rows, Adam7 if `interlace`), with PLTE and tRNS chunks
    when given: the twin devkit's encodings, which the devkit writers never
    use."""
    channels = {0: 1, 2: 3, 3: 1}[ctype]
    bpp = channels * depth // 8
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    body = []
    for x0, y0, dx, dy in passes if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = (sub.astype(">u2").view(np.uint8) if depth == 16 else sub.astype(np.uint8)).reshape(sub.shape[0], -1)
        sub_rows = rows.copy()
        sub_rows[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]  # uint8 wraps, as the Sub filter does
        body.append(np.concatenate([np.ones((rows.shape[0], 1), np.uint8), sub_rows], axis=1).tobytes())

    def chunk(ctype_: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + ctype_ + payload + struct.pack(">I", zlib.crc32(ctype_ + payload))

    h, w = samples.shape[:2]
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(body), 1)) + chunk(b"IEND", b"")


def twin_devkit(base: str, twin: str) -> list:
    """Copy the devkit `base` to `twin` and re-encode both sides' files
    under their own names.  Observed colour files cycle through P20_COLOR:
    a baseline JPEG in the base and the progressive JPEG of the same
    coefficients in the twin, or the base's RGB PNG as a palette PNG
    (Adam7; where the image has at most 256 colours, else Adam7 RGB), as
    16-bit RGB at v * 257 or as Adam7 RGB in the twin.  Every depth becomes
    16-bit gray Adam7 (every second one with a tRNS chunk), every label
    8-bit gray Adam7 (likewise).  A VOC pool (P20_VOC) goes in as baseline
    JPEGs in the base and progressive ones in the twin.  Returns the
    (base, twin, site mode, variant) of every file changed."""
    shutil.copytree(base, twin)
    pairs = []
    data = os.path.join(base, "data")
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(data) for f in fs if f.endswith(".png"))
    colour_i = 0
    for path in files:
        rel = os.path.relpath(path, base)
        kind = os.path.basename(path)[:-4].rsplit("-", 1)[-1]
        twin_path = os.path.join(twin, rel)
        if kind == "color" and f"{os.sep}observed{os.sep}" in path:
            rgb = read_png(path)
            variant = P20_COLOR[colour_i % len(P20_COLOR)]
            colour_i += 1
            if variant == "jpeg":
                with open(path, "wb") as f:
                    f.write(encode_jpeg(rgb, VOC_QUALITY, "420"))
                blob = encode_jpeg(rgb, VOC_QUALITY, "420", progressive=True)
                variant = "progressive JPEG"
            elif variant == "palette":
                colours, index = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True)
                if len(colours) <= 256:
                    blob = png_file(index.reshape(rgb.shape[0], rgb.shape[1], 1), 3, 8, palette=colours, interlace=True)
                    variant = "palette Adam7"
                else:
                    blob = png_file(rgb, 2, 8, interlace=True)
                    variant = f"RGB Adam7 ({len(colours)} colours: no palette)"
            elif variant == "rgb16":
                blob = png_file(rgb.astype(np.uint16) * 257, 2, 16)
                variant = "16-bit RGB (v * 257)"
            else:
                blob = png_file(rgb, 2, 8, interlace=True)
                variant = "RGB Adam7"
            mode = "color"
        elif kind in ("depth", "label"):
            img = read_png(path)
            depth = 16 if kind == "depth" else 8
            trns = struct.pack(">H", int(img[0, 0])) if len(pairs) % 2 else None
            blob = png_file(img[:, :, None], 0, depth, trns=trns, interlace=True)
            variant = f"{depth}-bit gray Adam7" + (" + tRNS" if trns else "")
            mode = "unchanged"
        else:
            continue
        with open(twin_path, "wb") as f:
            f.write(blob)
        pairs.append((path, twin_path, mode, variant))
    for root, progressive in ((base, False), (twin, True)):
        voc = os.path.join(root, "VOCdevkit", "VOC2012")
        os.makedirs(os.path.join(voc, "ImageSets", "Main"))
        os.makedirs(os.path.join(voc, "JPEGImages"))
        lines = []
        for i, (hw, sampling, restart) in enumerate(P20_VOC):
            name = f"2008_{i:06d}"
            with open(os.path.join(voc, "JPEGImages", f"{name}.jpg"), "wb") as f:
                f.write(encode_jpeg(voc_scene(hw, P20_SEED + i), VOC_QUALITY, sampling, restart, progressive))
            lines.append(f"{name}  1")
        with open(os.path.join(voc, "ImageSets", "Main", "diningtable_trainval.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    for i, (_, sampling, restart) in enumerate(P20_VOC):
        rel = os.path.join("VOCdevkit", "VOC2012", "JPEGImages", f"2008_{i:06d}.jpg")
        pairs.append((os.path.join(base, rel), os.path.join(twin, rel), "color",
                      f"VOC progressive JPEG {sampling}" + (f" RST {restart}" if restart else "")))
    return pairs


def twin_decodes(pairs: list, card: str) -> None:
    """Each twin file read by imread, in its site's mode, equals its base
    file bit for bit; logs the decode ms per image of each encoding (median
    over its files, on the host CPU)."""
    from deepim_tpu_torch.utils.imread import imread

    times = {}
    for base, twin, mode, variant in pairs:
        t0 = time.perf_counter()
        a = imread(base, mode)
        t1 = time.perf_counter()
        b = imread(twin, mode)
        t2 = time.perf_counter()
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"imread: {twin} ({variant}) differs from its twin {base} in mode {mode}")
        with open(base, "rb") as f:
            jpeg = f.read(3) == b"\xff\xd8\xff"
        base_kind = f"{'baseline JPEG' if jpeg else 'PNG as written'} ({mode})"
        if "VOC" in variant:
            base_kind = f"VOC baseline JPEG {a.shape[1]}x{a.shape[0]}"
        times.setdefault(base_kind, []).append((t1 - t0) * 1e3)
        times.setdefault(variant.split(" (")[0], []).append((t2 - t1) * 1e3)
    out = {k: statistics.median(v) for k, v in times.items()}
    log(f"[phase 20 decode] {len(pairs)} twin files equal to their base files under their sites' modes; imread ms "
        f"per image (median, host CPU; {H}x{W} but the VOC pool's): "
        + "; ".join(f"{k} {v:.1f} ({len(times[k])} files)" for k, v in out.items()) + f" [{card}]")


def p20_config(devkit: str, out_root: str, cls: str):
    """lm6d_ape_iter4_8epoch.yaml pointed at one class of a phase-20
    devkit (its bank that class alone), its VOC pool at
    REPLACE_OBSERVED_BG_RATIO RECIPE_BG_RATIO, one epoch from seeded
    weights, tested at that epoch."""
    cfg = update_config_dict(load_config(EVAL_CFG), {
        "output_path": out_root,
        "dataset": {"dataset_path": devkit, "root_path": devkit, "model_dir": os.path.join(devkit, "models"),
                    "class_name": [cls], "NUM_CLASSES": 1, "test_image_set": "val_"},
        "network": {"pretrained": ""},
        "TRAIN": {"end_epoch": 1, "grad_clip": RECIPE_TCFG.grad_clip, "REPLACE_OBSERVED_BG_RATIO": RECIPE_BG_RATIO},
        "TEST": {"test_epoch": 1},
    })
    return validate_config(cfg)


class ReadLog:
    """Every path data/preprocess.py hands utils/imread.py while installed
    (the drivers' reads: colour, depth, label and VOC files)."""

    def __init__(self):
        self.paths = []

    @contextlib.contextmanager
    def installed(self):
        from deepim_tpu_torch.data import preprocess

        real = preprocess.imread

        def logged(path, mode):
            self.paths.append((path, mode))
            return real(path, mode)

        preprocess.imread = logged
        try:
            yield self
        finally:
            preprocess.imread = real


def drive_phase20(dev, card: str) -> dict:
    """Phase 20 (see the module docstring).  Returns each kernel's check at
    its class's test render with its launches over the phase's driver runs
    (imread_ keys)."""
    from deepim_tpu_torch.tools.params_resume_parity import deterministic

    shutil.rmtree(PHASE20_DIR, ignore_errors=True)
    base, twin = os.path.join(PHASE20_DIR, "base"), os.path.join(PHASE20_DIR, "twin")
    write_devkit(base, P20_TRAIN, P20_VAL, dev, card, "phase 20")
    t0 = time.perf_counter()
    pairs = twin_devkit(base, twin)
    kinds = {}
    for *_, variant in pairs:
        kinds[variant] = kinds.get(variant, 0) + 1
    log(f"[phase 20 twin] {len(pairs)} files re-encoded in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} x{n}" for k, n in kinds.items()) + f" [{card}]")
    twin_decodes(pairs, card)

    checks, launches = {}, {"csr_raster": 0, "tile_raster": 0}
    for cls, kname in P20_KERNEL.items():
        cfg = {side: p20_config(root, os.path.join(PHASE20_DIR, f"out_{side}_{cls}"), cls)
               for side, root in (("base", base), ("twin", twin))}
        c = cfg["base"]
        b, n_inner, n_iter = c.TRAIN.BATCH_PAIRS, c.network.TRAIN_ITER_SIZE, c.TEST.test_iter
        bank = build_mesh_bank(c)
        ecfg = EngineConfig.from_config(c, bank_arrays=bank)
        _, recs = load_gt_pairdb(c, "LM6D_REFINE", f"val_{cls}", cls, base, base)
        m = MeshBuffers.gather(bank, np.zeros(EVAL_B, np.int64), device=dev)
        poses = np.stack([recs[i % len(recs)]["pose_rendered"] for i in range(EVAL_B)])
        plan = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(poses),
                             torch.from_numpy(c.dataset.intrinsic_matrix()), ecfg.raster, corners=m.corners,
                             corner_colors=m.corner_colors, device=dev)
        if {name for name, _ in plan} != {kname}:
            raise AssertionError(f"phase 20 {cls}: a test render plans {[name for name, _ in plan]}, want {kname}")
        kernel = check_kernel(kname, plan[0][1], card, shape=f"phase 20 {cls} test render")
        kernel.pop("out", None)
        model = make_model(True, P20_SEED, dev, hw=(c.height, c.width))
        init = build_model(c, device="cpu").state_dict()
        steps = 2 * P20_TRAIN // b
        runs = {}
        for side in ("base", "twin"):
            reads = ReadLog()
            with deterministic(dev), reads.installed():
                torch.cuda.synchronize()
                rk.reset_launch_counts()
                t0 = time.perf_counter()
                res = test_deepim(cfg[side], output_dir=os.path.join(PHASE20_DIR, f"test_{side}_{cls}"),
                                  batch_size=EVAL_B, device=dev, model=model)
                torch.cuda.synchronize()
                test_s = time.perf_counter() - t0
                test_counts = launch_counts()
                rk.reset_launch_counts()
                t0 = time.perf_counter()
                state = train_net(cfg[side], output_dir=os.path.join(PHASE20_DIR, f"train_{side}_{cls}"), device=dev,
                                  init_state_dict=init)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                train_counts = launch_counts()
            want_test = {**{k: 0 for k in launches}, "csr_planes_raster": 0, kname: len(plan) * n_iter}
            want_train = {**want_test, kname: len(plan) * n_inner * steps}
            if test_counts != want_test or train_counts != want_train:
                raise AssertionError(f"phase 20 {cls} {side}: launches {test_counts} (test), {train_counts} (train); "
                                     f"want {want_test}, {want_train}")
            launches[kname] += test_counts[kname] + train_counts[kname]
            e = state.epochs[0]
            if res["run"]["raster_dropped"] or e["nonfinite_losses"] or e["raster_dropped"]:
                raise AssertionError(f"phase 20 {cls} {side}: dropped {res['run']['raster_dropped']} / "
                                     f"{e['raster_dropped']}, non-finite losses {e['nonfinite_losses']}")
            voc = [p for p, _ in reads.paths if "JPEGImages" in p]
            kinds_read = {os.path.basename(p)[:-4].rsplit("-", 1)[-1] for p, _ in reads.paths}
            if not voc or not {"color", "depth", "label"} <= kinds_read:
                raise AssertionError(f"phase 20 {cls} {side}: the drivers read {sorted(kinds_read)} through imread, "
                                     f"{len(voc)} VOC backgrounds")
            with open(os.path.join(PHASE20_DIR, f"test_{side}_{cls}", "results_pose.pkl"), "rb") as f:
                poses = f.read()  # every iteration's estimates and the ground truth, pickled numpy arrays
            runs[side] = {"res": res, "poses": poses, "metrics": e["metrics"],
                          "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                          "test_s": test_s, "train_s": train_s, "loop_s": e["loop_s"], "reads": len(reads.paths),
                          "voc": len(voc)}
        a, t = runs["base"], runs["twin"]
        poses_equal = a["poses"] == t["poses"]
        tables_equal = all(all(np.array_equal(np.asarray(r1[k]), np.asarray(r2[k])) for k in r1)
                           for (_, _, _, r1), (_, _, _, r2) in zip(_table_rows(a["res"], [cls], n_iter),
                                                                   _table_rows(t["res"], [cls], n_iter)))
        losses_equal = set(a["metrics"]) == set(t["metrics"]) and all(
            np.array_equal(np.asarray(a["metrics"][k]), np.asarray(t["metrics"][k])) for k in a["metrics"])
        params_equal = all(torch.equal(v, t["params"][k]) for k, v in a["params"].items())
        if not (poses_equal and tables_equal and losses_equal and params_equal):
            raise AssertionError(f"phase 20 {cls}: twin vs base devkit: poses equal {poses_equal}, tables equal "
                                 f"{tables_equal}, losses equal {losses_equal}, trained parameters equal {params_equal}")
        check_tables(f"phase 20 {cls}", t["res"], [cls], n_iter)
        loss = {k: float(np.asarray(v)[-1, -1]) for k, v in t["metrics"].items() if k.endswith("loss")}
        log(f"[phase 20 {cls}] {kname}: test_deepim ({P20_VAL} pairs, batch {EVAL_B}, {n_iter} iterations) base "
            f"{a['test_s']:.3f} s / twin {t['test_s']:.3f} s; train_net ({steps} steps of {b} pairs x {n_inner}, VOC "
            f"ratio {RECIPE_BG_RATIO}) base {a['train_s']:.3f} s / twin {t['train_s']:.3f} s (loop {a['loop_s']:.3f} / "
            f"{t['loop_s']:.3f} s); imread calls {a['reads']} / {t['reads']}, VOC reads {a['voc']} / {t['voc']}; "
            f"under deterministic algorithms the twin's poses, tables, losses ({loss}) and trained parameters equal "
            f"the base's bit for bit; {kname} {len(plan)} a render, launches as planned [{card}]")
        checks[kname] = {"imread": kernel}
    for kname, entry in checks.items():
        entry["imread"]["launches"] = launches[kname]
    return checks


ALL_PHASES = set(range(1, 21))
KERNEL_PHASES = set(range(2, 7))  # phase 2's scenes carry phases 3-6: they run together


def parse_phases(text: str) -> set:
    """'20', '2-6,12' or '1-20' -> the phases to run.  Phase 1 (the device
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
    ap.add_argument("--phases", default="1-20", help="phases to run, e.g. 20 or 2-6,12 (default all, 1-20; phase 1 "
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

    results, heavy = {}, None
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
        results["csr_bin"] = check_csr_bin(card, dev)

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
        results["csr_bin"]["launches"] = eval_runs["bf16"][0]["bin_launches"]

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

    if phases & {7, 8, 9, 11, 12, 13}:
        for d in (PHASE8_DIR, PHASE9_DIR, PHASE11_DIR, PHASE13_DIR):
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
    extras = {}
    if 13 in phases:
        # 13. Unseen objects, texture sampling in both drivers, the standalone renderer.
        t13 = time.perf_counter()
        extras = drive_phase13(dev, card)
        log(f"[phase 13] took {time.perf_counter() - t13:.1f} s [{card}]")
    if 14 in phases:
        # 14. The synthetic accuracy and occlusion benchmarks.
        t14 = time.perf_counter()
        for name, runs in drive_phase14(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 14] took {time.perf_counter() - t14:.1f} s [{card}]")
    if 15 in phases:
        # 15. The data-preparation toolkit, then test_deepim on what it wrote.
        t15 = time.perf_counter()
        for name, runs in drive_phase15(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 15] took {time.perf_counter() - t15:.1f} s [{card}]")
    if 16 in phases:
        # 16. The training recipe from pretrained FlowNet weights, with VOC backgrounds.
        t16 = time.perf_counter()
        for name, runs in drive_recipe(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 16] took {time.perf_counter() - t16:.1f} s [{card}]")
    if 17 in phases:
        # 17. The module tail: flow2se3, pose metrics, mask dilation, visibility, visualize_minibatch.
        t17 = time.perf_counter()
        for name, runs in drive_phase17(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 17] took {time.perf_counter() - t17:.1f} s [{card}]")
    if 18 in phases:
        # 18. Learned tracking: a benchmark checkpoint, the tracking fine-tune, track_learned.
        t18 = time.perf_counter()
        for name, runs in drive_phase18(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 18] took {time.perf_counter() - t18:.1f} s [{card}]")
    if 19 in phases:
        # 19. A1's chained 480x640 run, synthetic_sanity, params_resume_parity.
        t19 = time.perf_counter()
        for name, runs in drive_phase19(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 19] took {time.perf_counter() - t19:.1f} s [{card}]")
    if 20 in phases:
        # 20. The image readers: a devkit and its re-encoded twin through both drivers.
        t20 = time.perf_counter()
        for name, runs in drive_phase20(dev, card).items():
            extras.setdefault(name, {}).update(runs)
        log(f"[phase 20] took {time.perf_counter() - t20:.1f} s [{card}]")
    log(f"[total] {time.perf_counter() - t_start:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    # The kernels line: each kernel's figures at phase 2's shapes with its
    # launches on its path (phases 3-5), then its figures at each driver's
    # renders as extra keys: tile_raster's heavy shape, csr_raster at the
    # eval and training drivers' renders (phases 8, 9), each kernel at the
    # full-width track's render (phase 11: sphere csr_raster, cube
    # tile_raster) and csr_raster at each refinement video's, and csr_raster
    # at rank 0's render of the data-parallel run (phase 12) with its
    # launches on each rank and the ranks; then each kernel at phase 13's
    # renders (modelnet_, textured_eval_, textured_train_, standalone_ keys:
    # lit colours, texture coordinates, the standalone renderer) and
    # tile_raster at phase 14's (bench_train_, occ_eval_ keys), and each
    # at phase 15's toolkit renders (toolkit_, toolkit_lit_ keys: its
    # class's first unlit and lit batch; its launches within BatchRenderer
    # over the toolkit's stages, unlit and lit as counted there), and
    # csr_raster at phase 16's recipe render (recipe_ keys) and at phase
    # 17's render of the flow2se3 targets (flow2se3_ keys), and tile_raster
    # at phase 18's track and fine-tune renders (track_learned_,
    # trackft_train_ keys) and phase 19's 480x640 training and test renders
    # (a1_480x640_train_, a1_480x640_test_ keys), and csr_raster and
    # tile_raster at phase 20's test renders with their launches over its
    # driver runs (imread_ keys).  Without phase 2, the first later figures
    # of a kernel are its own.  csr_bin's entry holds its figures at each
    # BIN_SHAPES shape (phase 2) and its launches on phase 3's eval path.
    base = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    for name, run in [("csr_raster", dp)] + [(n, next(iter(r.values()))) for n, r in extras.items()]:
        if run is not None and name not in results:
            results[name] = dict(run)
    kernels = []
    for name, r in results.items():
        entry = {"name": name, "route": "cuda", "source": "deepim_tpu_torch/csrc/raster.cu",
                 "replaces": REPLACES[name], "launches": r["launches"], **{key: r[key] for key in base},
                 "library_ms": r.get("library_ms")}
        if name == "csr_bin":
            entry.update({key: val for key, val in r.items() if key not in entry and key != "launches"})
        if name == "tile_raster" and heavy is not None:
            entry.update({f"heavy_{key}": heavy[key] for key in base})
        for tag, run in (("driver", driver), ("train_driver", trainer)):
            if run is not None and name == "csr_raster":
                entry.update({f"{tag}_{key}": run[key] for key in CHECK_KEYS})
        if tracks is not None and name in ("csr_raster", "tile_raster"):
            entry.update({f"track_{key}": tracks["sphere" if name == "csr_raster" else "cube"][key]
                          for key in CHECK_KEYS})
        if videos is not None and name == "csr_raster":
            entry["video_launches"] = videos["launches"]
            entry.update({f"video_{cls}_{key}": videos[cls][key] for cls in ("cube", "sphere") for key in base})
        if dp is not None and name == "csr_raster":
            entry.update({f"dp_{key}": dp[key] for key in CHECK_KEYS + ("world",)})
        for tag, run in extras.get(name, {}).items():
            entry.update({f"{tag}_{key}": run[key] for key in CHECK_KEYS})
        kernels.append(entry)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
