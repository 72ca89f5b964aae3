"""Pairdb statistics (lib/pair_matching/stat_se3.py, stat_depth.py;
counterpart of deepim_tpu/toolkit/stats.py).

`stat_se3` reports the mean/std of the untangled delta-pose labels
(rendered -> observed) over a pairdb plus the max rotation/translation
distance; `stat_depth` the min/max stored depth value.  The SE(3) deltas
are one batched call of geometry/se3.py:calc_RT_delta on `device`, in
float32 with t_means 0, t_stds 1 and CAMERA coordinates, as the JAX
module computes them.

    python -m deepim_tpu_torch.toolkit.stats --root <devkit> --image-set train_<cls> --cls <cls>
        [--what se3|depth|both] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from deepim_tpu_torch.data.pairdb import PairDB
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.geometry.rotations import mat2quat
from deepim_tpu_torch.geometry.se3 import calc_RT_delta
from deepim_tpu_torch.utils.imread import imread


def stat_se3(pairdb: list[dict], rot_coord: str = "CAMERA", device="cuda") -> tuple[np.ndarray, np.ndarray]:
    dev = resolve_device(device)

    def stacked(key):
        return torch.from_numpy(np.stack([p[key] for p in pairdb]).astype(np.float32)).to(dev)

    src, tgt = stacked("pose_rendered"), stacked("pose_observed")
    r_delta, t_delta = calc_RT_delta(src, tgt, torch.zeros(3, device=dev), torch.ones(3, device=dev), rot_coord)
    se3 = torch.cat([mat2quat(r_delta), t_delta], dim=1).cpu().numpy()
    se3_mean, se3_std = se3.mean(axis=0), se3.std(axis=0)

    # Distances (calc_rt_dist_m): geodesic rotation + translation norm.
    src, tgt = src.cpu().numpy(), tgt.cpu().numpy()
    rel = np.einsum("bij,bkj->bik", tgt[:, :, :3], src[:, :, :3])
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    r_dist = np.degrees(np.arccos(tr))
    t_dist = np.linalg.norm(tgt[:, :, 3] - src[:, :, 3], axis=1)
    print(f"mean: {se3_mean},\nstd: {se3_std}")
    print(f"R_max: {r_dist.max():.3f} deg, T_max: {t_dist.max():.4f} m")
    return se3_mean, se3_std


def stat_depth(pairdb: list[dict]) -> tuple[float, float]:
    files = sorted({p["depth_rendered"] for p in pairdb})
    max_val, min_val = -1.0, float("inf")
    for f in files:
        d = imread(f, "unchanged").astype(np.float32)
        max_val = max(max_val, float(d.max()))
        min_val = min(min_val, float(d.min()))
    print(f"max of depth value is {max_val}, min of depth value is {min_val}")
    return max_val, min_val


def main(argv: list[str] | None = None) -> dict:
    """The CLI; returns what it printed: {'se3': (mean, std)} and/or
    {'depth': (max, min)}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--image-set", required=True)
    ap.add_argument("--cls", required=True)
    ap.add_argument("--what", choices=["se3", "depth", "both"], default="both")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    db = PairDB(name="LM6D_REFINE", devkit_path=args.root, image_set=args.image_set, cur_class=args.cls)
    pairdb = db.gt_pairdb()
    out = {}
    if args.what in ("se3", "both"):
        out["se3"] = stat_se3(pairdb, device=dev)
    if args.what in ("depth", "both"):
        out["depth"] = stat_depth(pairdb)
    return out


if __name__ == "__main__":
    main()
