"""The video tracking CLI (counterpart of deepim_tpu/tools/track_video.py):
track one class's observed test sequence as a video.

Frame 0 starts from its stored initial pose (e.g. a PoseCNN estimate) and
every later frame from the previous frame's refined pose.  It reports each
frame's rotation and translation error against the ground truth and can
write an edge-overlay video: each observed frame with the silhouette of its
tracked pose in green, a lossless AVI of PNG frames (utils/avi.py; the JAX
package writes mp4v through cv2, which the port's host lacks).

    python -m deepim_tpu_torch.tools.track_video --cfg <yaml> --cls <c> [--ckpt-prefix P]
        [--iters-per-frame 2] [--out track.avi] [--device cuda|cpu]

Without CUDA it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from deepim_tpu_torch.config import Config, load_config
from deepim_tpu_torch.data.loader import TestLoader
from deepim_tpu_torch.data.pairdb import PairDB, load_gt_pairdb
from deepim_tpu_torch.device import resolve_device, set_explicit_precision, synchronize
from deepim_tpu_torch.engine.checkpoint import load_checkpoint
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, render_at_pose
from deepim_tpu_torch.engine.tracker import make_tracker
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.toolkit.gen_video import _edge_overlay, _to_u8
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model
from deepim_tpu_torch.utils.avi import check_avi_path, write_avi
from deepim_tpu_torch.utils.logger import logger

OVERLAY_FPS = 10.0


def _class_meshes(cfg: Config, db: PairDB, bank_arrays, dev) -> MeshBuffers:
    """The tracked class's mesh, at its index in cfg.dataset.class_name (the
    bank's order, and the loader's class_index).  The JAX driver indexes
    db.classes, the devkit's classes: the same index whenever the config
    lists every class of the devkit in sorted order."""
    return MeshBuffers.gather(bank_arrays, [list(cfg.dataset.class_name).index(db.cur_class)], device=dev)


def track_pairdb_sequence(cfg: Config, model, db: PairDB, pairdb: list[dict], bank_arrays,
                          iters_per_frame: int = 2, device="cuda"):
    """Track one class's observed sequence (the pair list in order) with
    `model`.  Returns (poses (T, 3, 4), rot_err (T,) degrees, trans_err (T,)
    metres, run), run holding 'frames', 'images' (the decoded observed
    frames, (T, 3, H, W) float32), 'decode_s' (reading and preprocessing the
    frames), 'track_s' (the track, from staging the video on the device to
    the poses on the host) and 'raster_dropped'."""
    dev = resolve_device(device)
    run = {}
    t0 = time.perf_counter()
    ecfg = EngineConfig.from_config(cfg, train=False, bank_arrays=bank_arrays, device=dev)
    frames, poses_gt, pose0 = [], [], None
    for batch, _valid in TestLoader(pairdb, cfg, batch_size=1).batches():
        frames.append(batch["image_observed"][0])
        poses_gt.append(batch["pose_observed"][0])
        if pose0 is None:
            pose0 = batch["pose_rendered"][0]
    run["images"] = np.stack(frames)
    meshes = _class_meshes(cfg, db, bank_arrays, dev)
    k = torch.from_numpy(cfg.dataset.intrinsic_matrix())
    run["frames"] = len(poses_gt)
    run["decode_s"] = time.perf_counter() - t0

    track = make_tracker(model, ecfg, iters_per_frame, with_stats=True, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    _, poses, stats = track(torch.from_numpy(run["images"])[:, None], meshes, k, torch.from_numpy(pose0[None]))
    poses = poses[:, 0].cpu().numpy()
    run["track_s"] = time.perf_counter() - t0
    run["raster_dropped"] = nd = int(stats["raster_dropped"])
    if nd:
        logger.warning("rasterizer dropped %d face-tile pairs during tracking - "
                       "renders had holes; raise RasterConfig.bin_pairs", nd)

    gt = np.stack(poses_gt)
    tr = np.einsum("tij,tij->t", poses[:, :, :3], gt[:, :, :3])
    rot_err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    trans_err = np.linalg.norm(poses[:, :, 3] - gt[:, :, 3], axis=-1)
    return poses, rot_err, trans_err, run


def write_track_video(cfg: Config, db: PairDB, bank_arrays, images: np.ndarray, poses: np.ndarray,
                      out_path: str, device="cuda") -> dict:
    """The edge-overlay video of a track: each observed frame (`images`,
    (T, 3, H, W) as track_pairdb_sequence decoded them) with the silhouette
    of its tracked pose, rendered one frame at a time, in green;
    OVERLAY_FPS frames a second.  Returns what write_avi returned."""
    check_avi_path(out_path)
    dev = resolve_device(device)
    ecfg = EngineConfig.from_config(cfg, train=False, bank_arrays=bank_arrays, device=dev)
    meshes = _class_meshes(cfg, db, bank_arrays, dev)
    k = torch.from_numpy(cfg.dataset.intrinsic_matrix())
    frames = []
    for image, pose in zip(images, poses):
        _, _, mask = render_at_pose(meshes, torch.from_numpy(pose[None]), k, ecfg, device=dev)
        frames.append(_edge_overlay(_to_u8(image.transpose(1, 2, 0)), mask[0, 0].cpu().numpy()))
    video = write_avi(out_path, frames, OVERLAY_FPS)
    logger.info("wrote %s", out_path)
    return video


def main(argv: list[str] | None = None) -> dict:
    """The CLI.  Sets the card's precision (set_explicit_precision), builds
    the bf16 network (build_model, seeded weights) and loads TEST.test_epoch
    of --ckpt-prefix into it when given.  Returns {'poses', 'rot_err',
    'trans_err', 'run'}: run holds track_pairdb_sequence's figures but the
    images and, with --out, 'video' (write_avi's figures) and 'overlay_s'
    (rendering, edges and writing the overlay)."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", required=True, help="experiment YAML file")
    ap.add_argument("--cls", required=True, help="the class whose test sequence is tracked")
    ap.add_argument("--ckpt-prefix", default=None)
    ap.add_argument("--iters-per-frame", type=int, default=2)
    ap.add_argument("--out", default=None, help="optional overlay video, a path ending in .avi")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.out:
        check_avi_path(args.out)
    dev = resolve_device(args.device)
    set_explicit_precision()
    cfg = load_config(args.cfg)
    model = build_model(cfg, device=dev)
    if args.ckpt_prefix:
        load_checkpoint(args.ckpt_prefix, cfg.TEST.test_epoch, TrainState(model, None))
    bank_arrays = build_mesh_bank(cfg)
    iset = cfg.dataset.test_image_set
    db, pairdb = load_gt_pairdb(
        cfg, cfg.dataset.dataset.split("+")[0], iset + args.cls if iset.endswith("_") else iset,
        args.cls, cfg.dataset.root_path, cfg.dataset.dataset_path,
    )
    poses, rot_err, trans_err, run = track_pairdb_sequence(cfg, model, db, pairdb, bank_arrays,
                                                           args.iters_per_frame, device=dev)
    images = run.pop("images")
    for t in range(len(rot_err)):
        logger.info("frame %03d: rot %.2f deg, trans %.1f mm", t, rot_err[t], trans_err[t] * 1000)
    logger.info("track %s: %d frames, mean rot %.2f deg, mean trans %.1f mm, max trans %.1f mm",
                args.cls, len(rot_err), rot_err.mean(), trans_err.mean() * 1000, trans_err.max() * 1000)
    if args.out:
        t0 = time.perf_counter()
        run["video"] = write_track_video(cfg, db, bank_arrays, images, poses, args.out, device=dev)
        run["overlay_s"] = time.perf_counter() - t0
    return {"poses": poses, "rot_err": rot_err, "trans_err": trans_err, "run": run}

if __name__ == "__main__":
    main()
