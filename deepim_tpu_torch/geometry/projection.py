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
