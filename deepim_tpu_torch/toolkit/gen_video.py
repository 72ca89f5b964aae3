"""Refinement-iteration videos (counterpart of deepim_tpu/toolkit/gen_video.py).

gen_refine_video runs the refinement engine on a set of test pairs and
writes a video where each frame shows, for one pair and one iteration, the
observed image with the render's silhouette edge in green, the render at the
current pose, and the zoomed (observed, rendered) pair the network sees.
images_to_video stacks PNG and JPEG files into a video.

Videos are lossless AVI files of PNG frames (utils/avi.py), where the JAX
package writes lossy mp4v through cv2; the port's host has no video
package, and an AVI needs none.  Edges come from utils/edges.py:canny,
equal to cv2.Canny.

    python -m deepim_tpu_torch.toolkit.gen_video --cfg <yaml> --cls <c> --out video.avi
        [--ckpt-prefix P] [--num-pairs 8] [--fps 2] [--mode iter_zoom|iter|single] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from deepim_tpu_torch.config import Config, load_config
from deepim_tpu_torch.data.loader import TestLoader
from deepim_tpu_torch.data.pairdb import load_gt_pairdb
from deepim_tpu_torch.device import resolve_device, set_explicit_precision
from deepim_tpu_torch.engine.checkpoint import load_checkpoint
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation, refine_step
from deepim_tpu_torch.engine.train import TrainState
from deepim_tpu_torch.tools.train_net import build_mesh_bank, build_model
from deepim_tpu_torch.utils.avi import check_avi_path, write_avi
from deepim_tpu_torch.utils.edges import canny
from deepim_tpu_torch.utils.imread import imread
from deepim_tpu_torch.utils.logger import logger

MODES = ("iter_zoom", "iter", "single")


def _to_u8(img) -> np.ndarray:
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def _edge_overlay(observed_rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Observed image with the rendered silhouette edge drawn in green."""
    edges = canny((mask * 255).astype(np.uint8), 50, 150)
    out = observed_rgb.copy()
    out[edges > 0] = (0, 255, 0)
    return out


def _resize(img_u8: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w) bilinear resize of an (H, W, C) uint8 image, sampled where
    cv2.resize(img, (w, h)) samples (align_corners=False, scale in / out);
    a copy when the size already matches, as in cv2.  cv2 rounds its
    weights to 11 bits, so a resized image may differ from cv2's by one
    grey level."""
    if img_u8.shape[:2] == (h, w):
        return img_u8.copy()
    x = torch.from_numpy(np.ascontiguousarray(img_u8, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    return out.round().clamp(0, 255).to(torch.uint8).numpy()


def compose_frame(obs_rgb, rend_rgb, mask, zoom_obs, zoom_rend) -> np.ndarray:
    """One video frame: [observed+overlay | rendered] over
    [zoom observed | zoom rendered], all HxW panels."""
    h, w = obs_rgb.shape[:2]
    top = np.concatenate([_edge_overlay(obs_rgb, mask), _to_u8(rend_rgb)], axis=1)
    bottom = np.concatenate([_resize(_to_u8(zoom_obs), h, w), _resize(_to_u8(zoom_rend), h, w)], axis=1)
    return np.concatenate([top, bottom], axis=0)


def images_to_video(image_paths: list[str], out_path: str, fps: float = 2.0) -> dict:
    """Stack image files into an AVI (write_avi), each read as the JAX
    package reads it with cv2.imread (utils/imread.py, "color": PNG or
    JPEG by content, whatever the name) and resized to the first one's
    size.  Other image formats raise."""
    h, w = imread(image_paths[0], "color").shape[:2]
    return write_avi(out_path, (_resize(imread(p, "color"), h, w) for p in image_paths), fps)


def gen_refine_video(cfg: Config, model, pairdb: list[dict], bank_arrays, out_path: str, num_pairs: int = 8,
                     fps: float = 2.0, mode: str = "iter_zoom", device="cuda") -> dict:
    """Refine the first `num_pairs` pairs (one batch) for TEST.test_iter
    iterations and write the per-iteration composition video(s); each
    sample's iterations are consecutive.

    mode: 'iter_zoom' (overlay and render over the zoomed pair), 'iter'
    (the overlay and render row only), or 'single' (one iter_zoom video per
    sample, written as <stem>_s<j><ext>).  `out_path` ends in .avi.

    Returns {'frames', 'videos', 'render_s' (refinement and copies to the
    host), 'compose_s' (edges and composition), 'encode_s' (PNG encoding),
    'write_s' (the whole write, encoding included)}."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    check_avi_path(out_path)
    dev = resolve_device(device)
    ecfg = EngineConfig.from_config(cfg, train=False, bank_arrays=bank_arrays, device=dev)
    n = min(num_pairs, len(pairdb))
    batch, valid = next(TestLoader(pairdb[:num_pairs], cfg, batch_size=n).batches())
    meshes = MeshBuffers.gather(bank_arrays, batch["class_index"], device=dev)
    obs = Observation(
        image_observed=torch.from_numpy(batch["image_observed"]),
        mask_observed=torch.from_numpy(batch["mask_observed"]),
        mask_gt_observed=None,
        depth_observed=torch.from_numpy(batch["depth_observed"]) if "depth_observed" in batch else None,
        k=torch.from_numpy(batch["k"]),
        class_index=torch.from_numpy(batch["class_index"]),
    ).to(dev)
    pose = torch.from_numpy(batch["pose_rendered"]).to(dev)
    obs_rgb = [_to_u8(batch["image_observed"][j].transpose(1, 2, 0)) for j in range(valid)]
    stats = {"render_s": 0.0, "compose_s": 0.0}
    frames = [[] for _ in range(valid)]
    with torch.no_grad():
        for _ in range(cfg.TEST.test_iter):
            t0 = time.perf_counter()
            pose, aux = refine_step(model, obs, meshes, pose, ecfg, device=dev)
            host = {key: aux[key][:valid].float().cpu().numpy()
                    for key in ("image_rendered", "mask_rendered", "zoom_image_observed", "zoom_image_rendered")}
            t1 = time.perf_counter()
            for j in range(valid):
                rend_rgb = host["image_rendered"][j].transpose(1, 2, 0)
                mask = host["mask_rendered"][j, 0]
                if mode == "iter":
                    fr = np.concatenate([_edge_overlay(obs_rgb[j], mask), _to_u8(rend_rgb)], axis=1)
                else:
                    fr = compose_frame(obs_rgb[j], rend_rgb, mask, host["zoom_image_observed"][j].transpose(1, 2, 0),
                                       host["zoom_image_rendered"][j].transpose(1, 2, 0))
                frames[j].append(fr)
            stats["render_s"] += t1 - t0
            stats["compose_s"] += time.perf_counter() - t1

    t0 = time.perf_counter()
    if mode == "single":
        stem, ext = os.path.splitext(out_path)
        written = [write_avi(f"{stem}_s{j}{ext}", frames[j], fps) for j in range(valid)]
    else:
        written = [write_avi(out_path, [fr for per_sample in frames for fr in per_sample], fps)]
    stats["write_s"] = time.perf_counter() - t0
    stats.update(frames=sum(w["frames"] for w in written), videos=len(written),
                 encode_s=sum(w["encode_s"] for w in written))
    logger.info("wrote %d frames to %s", stats["frames"], out_path if mode != "single" else f"{stem}_s*{ext}")
    return stats


def main(argv: list[str] | None = None) -> dict:
    """The CLI: gen_refine_video for one class, with the bf16 network
    (build_model) of TEST.test_epoch's checkpoint under --ckpt-prefix, or
    its seeded initial weights."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--out", required=True, help="output .avi path")
    ap.add_argument("--cls", required=True)
    ap.add_argument("--ckpt-prefix", default=None)
    ap.add_argument("--num-pairs", type=int, default=8)
    ap.add_argument("--fps", type=float, default=2.0)
    ap.add_argument("--mode", default="iter_zoom", choices=MODES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_explicit_precision()
    cfg = load_config(args.cfg)
    model = build_model(cfg, device=dev)
    if args.ckpt_prefix:
        load_checkpoint(args.ckpt_prefix, cfg.TEST.test_epoch, TrainState(model, None))
    bank_arrays = build_mesh_bank(cfg)
    iset = cfg.dataset.test_image_set
    _, pairdb = load_gt_pairdb(
        cfg, cfg.dataset.dataset.split("+")[0], iset + args.cls if iset.endswith("_") else iset,
        args.cls, cfg.dataset.root_path, cfg.dataset.dataset_path,
    )
    return gen_refine_video(cfg, model, pairdb, bank_arrays, args.out, args.num_pairs, args.fps, args.mode,
                            device=dev)


if __name__ == "__main__":
    main()
