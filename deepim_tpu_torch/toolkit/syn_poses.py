"""Synthetic-observed-data pipeline (the LM6d_refine_syn / data_syn set;
counterpart of deepim_tpu/toolkit/syn_poses.py).

Re-implements toolkit/LM6d_ds_0..5:

* `stat` / `gen_poses` (LM6d_ds_0_gen_observed_poses.py): fit per-class
  statistics of the real observed poses — translation mean/std and the cone
  of viewing directions (R @ [0,0,1], its mean and max angular spread) — then
  sample `--num-images` synthetic poses per class: uniform random unit
  quaternion (w >= 0) + N(trans_mean, trans_std) translation, rejection-
  resampled until the rotated z axis lies inside the observed cone and the
  projected center is >= 48 px inside the frame (ds_0:195-230).
* `gen_observed` (LM6d_ds_1/ds_2): render the sampled poses with the
  point-light model — light position cycling through 6 directions offset by
  the (yz-flipped) object position, a random color from 7 choices scaled by
  U(0.9, 1.1), random brightness ratio in {0.4, 0.3, 0.2} (ds_1:116-148) —
  writing data/observed + identical data/gt_observed frames and the
  per-class observed set list.
* `check` (LM6d_ds_5_check.py): non-interactive dataset sanity check —
  verifies every pair's files exist, labels match depth>0, and pose files
  round-trip; with --vis-dir writes side-by-side observed/rendered PNGs instead
  of plt.show().

The rendered/init-pose half of the syn pipeline (ds_3, ds_4) is identical
machinery to the real pipeline — run toolkit.gen_rendered_pose and
toolkit.gen_rendered against the syn root.

The draws keep the JAX module's order: gen_poses shares one RandomState
across classes; gen_observed makes its two light generators once, before
the class loop, and for each frame draws the colour index (random.Random)
before its U(0.9, 1.1) scale (RandomState), then every frame's brightness.

    python -m deepim_tpu_torch.toolkit.syn_poses gen-poses --real-root <devkit> --syn-root <syn>
        [--classes C ...] [--num-images 10000] [--seed 2333] [--device cuda|cpu]
    python -m deepim_tpu_torch.toolkit.syn_poses gen-observed --syn-root <syn> [--classes C ...]
        [--models-root <devkit>/models] [--batch 8] [--seed 2333] [--device cuda|cpu]
    python -m deepim_tpu_torch.toolkit.syn_poses check --syn-root <syn> [--classes C ...]
        [--image-set train] [--vis-dir <dir>] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from scipy.spatial.transform import Rotation as R

from deepim_tpu_torch.data.pairdb import load_pose_file
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.toolkit._common import (
    DEFAULT_K,
    HEIGHT,
    PNG_FILTER,
    WIDTH,
    BatchRenderer,
    Devkit,
    load_observed_pose,
    resolve_classes,
    write_color_png,
    write_depth_png,
    write_label_png,
    write_pose_file_with_class,
)
from deepim_tpu_torch.utils.imread import imread
from deepim_tpu_torch.utils.png import write_png

CENTER_MARGIN = 48  # ds_0:230 (tighter than the real pipeline's 16)
BRIGHTNESS_RATIOS = (0.4, 0.3, 0.2)  # ds_1:86
LIGHT_DIRS = np.array(
    [[1, 0, 1], [1, 1, 1], [0, 1, 1], [-1, 1, 1], [-1, 0, 1], [0, 0, 1]], np.float64
)  # ds_1:116-128
LIGHT_COLORS = np.array(
    [[0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float64
)  # ds_1:138


def _angle_deg(u: np.ndarray, v: np.ndarray) -> float:
    c = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def stat_observed_poses(real_root: str, classes: dict[int, str], image_set: str = "train") -> dict:
    """Per-class pose statistics of the real observed data (ds_0 stat_poses)."""
    dk = Devkit(real_root)
    pz = np.array([0.0, 0.0, 1.0])
    stats = {}
    for cls_idx, cls_name in classes.items():
        trans, pzs = [], []
        for observed_idx in dk.observed_indices(cls_name, image_set):
            pose = load_observed_pose(dk, cls_name, cls_idx, observed_idx)
            trans.append(pose[:, 3])
            pzs.append(pose[:, :3] @ pz)
        trans = np.stack(trans)
        pzs = np.stack(pzs)
        pz_mean = pzs.mean(axis=0)
        angles = [_angle_deg(pz_mean, p) for p in pzs]
        stats[cls_name] = {
            "trans_mean": trans.mean(axis=0),
            "trans_std": trans.std(axis=0),
            "pz_mean": pz_mean,
            "angle_max": float(np.max(angles)),
        }
    return stats


def sample_syn_pose(
    stat: dict, rng: np.random.RandomState, k: np.ndarray = DEFAULT_K,
    width: int = WIDTH, height: int = HEIGHT, margin: int = CENTER_MARGIN,
    max_tries: int = 100_000,
) -> np.ndarray:
    """One accepted synthetic pose (ds_0 gen_poses rejection loop).  The
    reference loops forever; here an unsatisfiable acceptance region (e.g. a
    margin wider than the frame) raises instead of hanging."""
    if 2 * margin >= min(width, height):
        raise ValueError(f"center margin {margin} leaves no acceptance region at {width}x{height}")
    pz = np.array([0.0, 0.0, 1.0])
    for _ in range(max_tries):
        quat = rng.normal(0, 1, 4)
        quat /= np.linalg.norm(quat)
        if quat[0] < 0:
            quat = -quat
        trans = rng.normal(stat["trans_mean"], stat["trans_std"])
        rot = R.from_quat([quat[1], quat[2], quat[3], quat[0]]).as_matrix()
        deg = _angle_deg(rot @ pz, stat["pz_mean"])
        proj = k @ trans.reshape(3, 1)
        cx, cy = float(proj[0, 0] / proj[2, 0]), float(proj[1, 0] / proj[2, 0])
        if deg <= stat["angle_max"] and (
            margin < cx < width - margin and margin < cy < height - margin
        ):
            return np.concatenate([rot, trans[:, None]], axis=1).astype(np.float32)
    raise RuntimeError(f"no accepted pose after {max_tries} draws")


def gen_poses(
    real_root: str, syn_root: str, classes: list[str] | None = None,
    num_images: int = 10000, seed: int = 2333, stat_set: str = "train",
    k: np.ndarray = DEFAULT_K, width: int = WIDTH, height: int = HEIGHT,
    margin: int = CENTER_MARGIN,
) -> str:
    cls_map = resolve_classes(classes)
    stats = stat_observed_poses(real_root, cls_map, stat_set)
    rng = np.random.RandomState(seed)
    pose_dir = os.path.join(syn_root, "poses")
    os.makedirs(pose_dir, exist_ok=True)
    observed_pose_dict = {}
    for cls_idx, cls_name in cls_map.items():
        poses = np.stack([sample_syn_pose(stats[cls_name], rng, k, width, height, margin) for _ in range(num_images)])
        observed_pose_dict[cls_name] = poses
        print(f"{cls_name}: {num_images} syn poses (cone {stats[cls_name]['angle_max']:.1f} deg)")
    out = os.path.join(pose_dir, "LM6d_ds_train_observed_pose_all.pkl")
    with open(out, "wb") as f:
        pickle.dump(observed_pose_dict, f, protocol=4)
    return out


def gen_observed(
    syn_root: str, classes: list[str] | None = None, seed: int = 2333,
    k: np.ndarray = DEFAULT_K, batch: int = 8, models_root: str | None = None,
    width: int = WIDTH, height: int = HEIGHT, device="cuda",
) -> None:
    """Render the sampled syn poses with random point lights (ds_1 + the
    gt_observed copy of ds_2, which renders the same poses unlit)."""
    import random as _random

    dev = resolve_device(device)
    dk = Devkit(syn_root)
    pose_pkl = os.path.join(syn_root, "poses", "LM6d_ds_train_observed_pose_all.pkl")
    with open(pose_pkl, "rb") as f:
        observed_pose_dict = pickle.load(f)
    rnd = _random.Random(seed)
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(dk.pair_set_dir, "observed"), exist_ok=True)
    models_dir = models_root or dk.models_dir

    for cls_idx, cls_name in resolve_classes(classes).items():
        if cls_name not in observed_pose_dict:
            continue
        poses = np.asarray(observed_pose_dict[cls_name])
        n = poses.shape[0]
        obs_dir = os.path.join(dk.observed_dir, cls_name)
        gt_dir = os.path.join(dk.gt_observed_dir, cls_name)
        os.makedirs(obs_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)

        # Reference light schedule (ds_1:116-148).
        light_pos = LIGHT_DIRS[np.arange(n) % 6] * 0.5
        light_pos[:, 0] += poses[:, 0, 3]
        light_pos[:, 1] -= poses[:, 1, 3]
        light_pos[:, 2] -= poses[:, 2, 3]
        light_int = np.stack(
            [LIGHT_COLORS[rnd.randint(0, 6)] * rng.uniform(0.9, 1.1, 3) for _ in range(n)]
        )
        bright_k = np.array([BRIGHTNESS_RATIOS[rnd.randint(0, 2)] for _ in range(n)], np.float32)

        renderer = BatchRenderer(os.path.join(models_dir, cls_name), k, width=width, height=height, batch=batch,
                                 device=dev)
        set_lines = []
        lit_iter = renderer.render_many_lit(poses, light_pos, light_int, bright_k)
        unlit_iter = renderer.render_many(poses)
        for i, ((rgb, depth), (gt_rgb, gt_depth)) in enumerate(zip(lit_iter, unlit_iter)):
            prefix = f"{i + 1:06d}"
            set_lines.append(f"{cls_name}/{prefix}")
            write_color_png(os.path.join(obs_dir, f"{prefix}-color.png"), rgb)
            write_depth_png(os.path.join(obs_dir, f"{prefix}-depth.png"), depth)
            write_label_png(os.path.join(obs_dir, f"{prefix}-label.png"), depth != 0)
            write_pose_file_with_class(
                os.path.join(obs_dir, f"{prefix}-pose.txt"), cls_idx, poses[i]
            )
            write_color_png(os.path.join(gt_dir, f"{prefix}-color.png"), gt_rgb)
            write_depth_png(os.path.join(gt_dir, f"{prefix}-depth.png"), gt_depth)
            write_pose_file_with_class(
                os.path.join(gt_dir, f"{prefix}-pose.txt"), cls_idx, poses[i]
            )
        set_path = os.path.join(
            dk.pair_set_dir, "observed", f"LM6d_data_syn_train_observed_{cls_name}.txt"
        )
        with open(set_path, "w") as f:
            f.write("\n".join(set_lines) + "\n")
        # Also the <cls>_all.txt convention so gen_rendered_pose/gen_rendered
        # work unchanged against the syn root.
        with open(os.path.join(dk.pair_set_dir, "observed", f"{cls_name}_all.txt"), "w") as f:
            f.write("\n".join(set_lines) + "\n")
        print(f"{cls_name}: {n} syn observed frames")


def check(syn_root: str, classes: list[str] | None = None, image_set: str = "train",
          vis_dir: str | None = None, max_vis: int = 4) -> dict:
    """Dataset sanity check (LM6d_ds_5_check.py, non-interactive): all pair
    files exist, labels agree with depth > 0, pose files parse.  With
    vis_dir, the first max_vis pairs of a class as observed | rendered |
    |difference| PNGs."""
    dk = Devkit(syn_root)
    report = {"pairs": 0, "missing": [], "label_mismatch": []}
    for cls_idx, cls_name in resolve_classes(classes).items():
        set_file = os.path.join(dk.pair_set_dir, f"{image_set}_{cls_name}.txt")
        if not os.path.exists(set_file):
            continue
        with open(set_file) as f:
            pairs = [x.strip().split() for x in f if x.strip()]
        for vi, (obs_idx, rend_idx) in enumerate(pairs):
            report["pairs"] += 1
            prefix = obs_idx.split("/")[-1]
            files = {
                "observed_color": os.path.join(dk.observed_dir, f"{obs_idx}-color.png"),
                "observed_depth": os.path.join(dk.observed_dir, f"{obs_idx}-depth.png"),
                "observed_label": os.path.join(dk.observed_dir, f"{obs_idx}-label.png"),
                "gt_observed_depth": os.path.join(dk.gt_observed_dir, cls_name, f"{prefix}-depth.png"),
                "gt_observed_pose": os.path.join(dk.gt_observed_dir, cls_name, f"{prefix}-pose.txt"),
                "rendered_color": os.path.join(dk.rendered_dir, f"{rend_idx}-color.png"),
                "rendered_depth": os.path.join(dk.rendered_dir, f"{rend_idx}-depth.png"),
                "rendered_pose": os.path.join(dk.rendered_dir, f"{rend_idx}-pose.txt"),
            }
            missing = [k for k, p in files.items() if not os.path.exists(p)]
            if missing:
                report["missing"].append((obs_idx, missing))
                continue
            depth = imread(files["gt_observed_depth"], "unchanged")
            label = imread(files["observed_label"], "unchanged")
            iou = np.logical_and(depth > 0, label > 0).sum() / max(
                np.logical_or(depth > 0, label > 0).sum(), 1
            )
            if iou < 0.5:
                report["label_mismatch"].append((obs_idx, float(iou)))
            load_pose_file(files["rendered_pose"])
            load_pose_file(files["gt_observed_pose"])
            if vis_dir and vi < max_vis:
                os.makedirs(vis_dir, exist_ok=True)
                obs = imread(files["observed_color"], "color")
                rend = imread(files["rendered_color"], "color")
                diff = np.abs(obs.astype(np.int16) - rend.astype(np.int16)).astype(np.uint8)
                write_png(os.path.join(vis_dir, f"{cls_name}_{prefix}_check.png"),
                          np.concatenate([obs, rend, diff], axis=1), PNG_FILTER)
    print(
        f"check: {report['pairs']} pairs, {len(report['missing'])} missing,"
        f" {len(report['label_mismatch'])} label mismatches"
    )
    return report


def main(argv: list[str] | None = None):
    """The CLI; returns the sub-command's result (gen-poses: the pickle's
    path; check: its report)."""
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("gen-poses")
    p.add_argument("--real-root", required=True)
    p.add_argument("--syn-root", required=True)
    p.add_argument("--classes", nargs="*", default=None)
    p.add_argument("--num-images", type=int, default=10000)
    p.add_argument("--seed", type=int, default=2333)
    p = sub.add_parser("gen-observed")
    p.add_argument("--syn-root", required=True)
    p.add_argument("--classes", nargs="*", default=None)
    p.add_argument("--models-root", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=2333)
    p = sub.add_parser("check")
    p.add_argument("--syn-root", required=True)
    p.add_argument("--classes", nargs="*", default=None)
    p.add_argument("--image-set", default="train")
    p.add_argument("--vis-dir", default=None)
    for p in sub.choices.values():
        p.add_argument("--device", default="cuda", help="gen-observed renders on it; the others run on the host")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.cmd == "gen-poses":
        return gen_poses(args.real_root, args.syn_root, args.classes, args.num_images, args.seed)
    if args.cmd == "gen-observed":
        return gen_observed(args.syn_root, args.classes, args.seed, batch=args.batch,
                            models_root=args.models_root, device=args.device)
    return check(args.syn_root, args.classes, args.image_set, args.vis_dir)


if __name__ == "__main__":
    main()
