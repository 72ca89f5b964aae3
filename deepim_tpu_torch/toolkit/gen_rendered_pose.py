"""Sample perturbed initial poses for every observed GT pose (counterpart of
deepim_tpu/toolkit/gen_rendered_pose.py; numpy and scipy only, so a seed
writes the same file byte for byte).

Re-implements toolkit/LM6d_1_gen_rendered_pose.py: per observed frame, draw
`--per-observed` (default 10) poses with per-axis euler noise N(0, 15 deg)
and translation noise N(0, (0.01, 0.01, 0.05)) m, rejection-resampled until
the rotation distance is <= 45 deg and the projected object center stays
at least 16 px inside the frame (LM6d_1:51-55, :85-110).  Output:
rendered_poses/LM6d_<set>_rendered_pose_<cls>.txt with one "qw qx qy qz x y
z" line per sample (LM6d_1:120-124).

    python -m deepim_tpu_torch.toolkit.gen_rendered_pose --root <devkit> [--classes C ...]
        [--image-set all] [--per-observed 10] [--seed 2333] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
from math import pi

import numpy as np
from scipy.spatial.transform import Rotation as R

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.toolkit._common import (
    DEFAULT_K,
    HEIGHT,
    WIDTH,
    Devkit,
    load_observed_pose,
    resolve_classes,
)

ANGLE_STD_DEG = 15.0
ANGLE_MAX_DEG = 45.0
TRANS_STD = (0.01, 0.01, 0.05)
CENTER_MARGIN = 16


def _rot_dist_deg(r_a: np.ndarray, r_b: np.ndarray) -> float:
    cos = np.clip((np.trace(r_a @ r_b.T) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def _center_ok(k: np.ndarray, t: np.ndarray, width: int, height: int) -> bool:
    proj = k @ t.reshape(3, 1)
    cx, cy = float(proj[0, 0] / proj[2, 0]), float(proj[1, 0] / proj[2, 0])
    return (CENTER_MARGIN < cx < width - CENTER_MARGIN) and (
        CENTER_MARGIN < cy < height - CENTER_MARGIN
    )


def sample_rendered_pose(
    src_pose: np.ndarray,
    rng: np.random.RandomState,
    k: np.ndarray = DEFAULT_K,
    width: int = WIDTH,
    height: int = HEIGHT,
) -> tuple[np.ndarray, float, float]:
    """One accepted perturbed pose; additive euler noise on the source
    angles, as the reference (tgt_euler = src_euler + N(0, std)).  Returns
    (pose (3,4), r_dist_deg, t_dist_m)."""
    src_euler = R.from_matrix(src_pose[:, :3]).as_euler("xyz")
    src_trans = src_pose[:, 3]
    for _ in range(100_000):
        tgt_euler = src_euler + rng.normal(0, ANGLE_STD_DEG / 180.0 * pi, 3)
        tgt_trans = src_trans + np.array(
            [rng.normal(0, TRANS_STD[0]), rng.normal(0, TRANS_STD[1]), rng.normal(0, TRANS_STD[2])]
        )
        tgt_rot = R.from_euler("xyz", tgt_euler).as_matrix()
        r_dist = _rot_dist_deg(tgt_rot, src_pose[:, :3])
        if r_dist <= ANGLE_MAX_DEG and _center_ok(k, tgt_trans, width, height):
            pose = np.concatenate([tgt_rot, tgt_trans[:, None]], axis=1).astype(np.float32)
            return pose, r_dist, float(np.linalg.norm(tgt_trans - src_trans))
    raise RuntimeError("no accepted perturbed pose after 100000 draws")


def pose_to_line(pose: np.ndarray) -> str:
    q = R.from_matrix(pose[:, :3]).as_quat()  # scipy: (x, y, z, w)
    quat = np.array([q[3], q[0], q[1], q[2]])
    if quat[0] < 0:
        quat = -quat
    return " ".join(str(v) for v in np.concatenate([quat, pose[:, 3]]))


def line_to_pose(line: str) -> np.ndarray:
    v = np.array([float(x) for x in line.split()])
    rot = R.from_quat([v[1], v[2], v[3], v[0]]).as_matrix()
    return np.concatenate([rot, v[4:7][:, None]], axis=1).astype(np.float32)


def gen_rendered_pose(
    root: str,
    classes: list[str] | None = None,
    image_set: str = "all",
    per_observed: int = 10,
    seed: int = 2333,
    k: np.ndarray = DEFAULT_K,
    width: int = WIDTH,
    height: int = HEIGHT,
) -> None:
    dk = Devkit(root)
    os.makedirs(dk.rendered_pose_dir, exist_ok=True)
    for cls_idx, cls_name in resolve_classes(classes).items():
        rng = np.random.RandomState(seed)
        lines, rd, td = [], [], []
        for observed_idx in dk.observed_indices(cls_name, image_set):
            src_pose = load_observed_pose(dk, cls_name, cls_idx, observed_idx)
            for _ in range(per_observed):
                pose, r_dist, t_dist = sample_rendered_pose(src_pose, rng, k, width, height)
                lines.append(pose_to_line(pose))
                rd.append(r_dist)
                td.append(t_dist)
        out = os.path.join(
            dk.rendered_pose_dir, f"LM6d_{image_set}_rendered_pose_{cls_name}.txt"
        )
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(
            f"{cls_name}: {len(lines)} poses, r dist {np.mean(rd):.2f} +/- {np.std(rd):.2f} deg,"
            f" t dist {np.mean(td)*100:.2f} +/- {np.std(td)*100:.2f} cm"
        )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--classes", nargs="*", default=None)
    ap.add_argument("--image-set", default="all")
    ap.add_argument("--per-observed", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2333)
    ap.add_argument("--device", default="cuda", help="checked like every toolkit stage's; this one draws on the host")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    gen_rendered_pose(args.root, args.classes, args.image_set, args.per_observed, args.seed)


if __name__ == "__main__":
    main()
