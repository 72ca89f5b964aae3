"""Pose-error metrics: ADD, ADI, rotation and translation error, 2D
reprojection error (PyTorch counterpart of
deepim_tpu/geometry/pose_metrics.py; Hodan et al., "On Evaluation of 6D
Object Pose Estimation").  Batched over leading dims, on tensors of any
device, so a test set is scored on the card; eval/evaluator.py holds the
float64 host versions the tables use."""
from __future__ import annotations

import torch

from deepim_tpu_torch.geometry.rotations import rot_geodesic_deg


def transform_pts(pts: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """pts: (..., N, 3), r: (..., 3, 3), t: (..., 3) -> (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", r, pts) + t[..., None, :]


def add(r_est, t_est, r_gt, t_gt, pts) -> torch.Tensor:
    """Mean distance between the model points under the two poses. -> (...,)"""
    pe = transform_pts(pts, r_est, t_est)
    pg = transform_pts(pts, r_gt, t_gt)
    return torch.mean(torch.linalg.norm(pe - pg, dim=-1), dim=-1)


def adi(r_est, t_est, r_gt, t_gt, pts, *, chunk: int = 512) -> torch.Tensor:
    """ADD for symmetric objects: mean over the gt-posed points of the
    distance to the nearest estimate-posed point.  Exact nearest neighbour
    by pairwise squared distances, `chunk` gt points at a time (memory
    O(chunk * N) per batch element), then min, then sqrt."""
    pe = transform_pts(pts, r_est, t_est)
    pg = transform_pts(pts, r_gt, t_gt)
    mins = []
    for start in range(0, pg.shape[-2], chunk):
        g = pg[..., start:start + chunk, :]
        d2 = torch.sum((g[..., :, None, :] - pe[..., None, :, :]) ** 2, dim=-1)
        mins.append(torch.amin(d2, dim=-1))
    return torch.mean(torch.sqrt(torch.cat(mins, dim=-1)), dim=-1)


def re(r_est, r_gt) -> torch.Tensor:
    """Rotation geodesic error in degrees."""
    return rot_geodesic_deg(r_est, r_gt)


def te(t_est, t_gt) -> torch.Tensor:
    """Translation L2 error."""
    return torch.linalg.norm(t_gt - t_est, dim=-1)


def arp_2d(r_est, t_est, r_gt, t_gt, pts, k) -> torch.Tensor:
    """Mean 2D reprojection error in pixels; k: (3, 3)."""
    pe = torch.einsum("ij,...nj->...ni", k, transform_pts(pts, r_est, t_est))
    pg = torch.einsum("ij,...nj->...ni", k, transform_pts(pts, r_gt, t_gt))
    pe2 = pe[..., :2] / pe[..., 2:3]
    pg2 = pg[..., :2] / pg[..., 2:3]
    return torch.mean(torch.linalg.norm(pe2 - pg2, dim=-1), dim=-1)
