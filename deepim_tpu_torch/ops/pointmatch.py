"""Differentiable pose update + model-point transform (PyTorch counterpart
of deepim_tpu/ops/pointmatch.py).  The backward pass is autograd; the
gradient reaches only (rotation, translation): the model points and the
source pose are detached."""
from __future__ import annotations

import torch

from deepim_tpu_torch.geometry.se3 import RT_transform


def transform3d(points_model, quat, trans_delta, pose_src, t_means=0.0, t_stds=1.0,
                rot_coord: str = "CAMERA"):
    """Apply the predicted delta to pose_src and transform the model points.

    points_model: (B, N, 3); quat: (B, 4); trans_delta: (B, 3); pose_src:
    (B, 3, 4).  Returns (B, N, 3) camera-frame points R_tgt p + t_tgt."""
    pose_tgt = RT_transform(pose_src.detach(), quat, trans_delta, t_means, t_stds, rot_coord)
    r, t = pose_tgt[..., :3, :3], pose_tgt[..., :3, 3]
    return torch.einsum("bij,bnj->bni", r, points_model.detach()) + t[:, None, :]
