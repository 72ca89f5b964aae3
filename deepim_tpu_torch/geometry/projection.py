"""Pinhole projection (PyTorch counterpart of
deepim_tpu/geometry/projection.py).  Integer pixel index (w, h) maps
through K directly, with no half-pixel offset."""
from __future__ import annotations

import torch


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None):
    """(h_idx, w_idx) index grids, each (H, W)."""
    hh = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    ww = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    return hh, ww


def project_points(points: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> (w, h) pixel coordinates (..., 2)."""
    uvw = torch.einsum("ij,...j->...i", k, points)
    w = uvw[..., 2]
    z = w + torch.sign(w) * 1e-15 + torch.where(w == 0, 1e-15, 0.0)
    return uvw[..., :2] / z[..., None]


def backproject_pixels(depth: torch.Tensor, k_inv: torch.Tensor) -> torch.Tensor:
    """Depth maps (..., H, W) -> camera-frame points (..., H, W, 3):
    (x, y, z) = K^-1 (w, h, 1) * depth."""
    hh, ww = pixel_grid(depth.shape[-2], depth.shape[-1], depth.dtype, depth.device)
    x = (ww * k_inv[0, 0] + hh * k_inv[0, 1] + k_inv[0, 2]) * depth
    y = (ww * k_inv[1, 0] + hh * k_inv[1, 1] + k_inv[1, 2]) * depth
    return torch.stack([x, y, depth], dim=-1)


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) poses applied to (..., N, 3) points -> (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", pose[..., :3, :3], points) + pose[..., None, :3, 3]


def project_pose_center(k: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """The object origin under (..., 3, 4) poses -> (w, h) pixels (..., 2)."""
    return project_points(pose[..., :3, 3], k)
