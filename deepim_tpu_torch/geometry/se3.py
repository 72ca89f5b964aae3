"""Batched SE(3) math and DeepIM's untangled delta pose (PyTorch
counterpart of deepim_tpu/geometry/se3.py).  Poses are (..., 3, 4)."""
from __future__ import annotations

import torch

from deepim_tpu_torch.geometry.rotations import euler2mat, quat2mat, quat_normalize


def make_pose(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 3, 4)."""
    return torch.cat([r, t[..., None]], dim=-1)


def se3_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Inverse of [R|t]: [R^T | -R^T t]."""
    r_inv = pose[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", r_inv, pose[..., :3, 3])
    return make_pose(r_inv, t_inv)


def se3_mul(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """[Ra|ta] @ [Rb|tb] -> [Ra Rb | Ra tb + ta]."""
    ra, ta = pose_a[..., :3, :3], pose_a[..., :3, 3]
    rb, tb = pose_b[..., :3, :3], pose_b[..., :3, 3]
    r = torch.einsum("...ij,...jk->...ik", ra, rb)
    t = torch.einsum("...ij,...j->...i", ra, tb) + ta
    return make_pose(r, t)


def _check_coord(rot_coord: str) -> str:
    rc = rot_coord.lower()
    if rc not in ("model", "camera", "camera_new", "naive"):
        raise ValueError(f"Unknown rot_coord: {rot_coord}")
    return rc


def R_transform(r_src: torch.Tensor, r_delta: torch.Tensor, rot_coord: str = "CAMERA") -> torch.Tensor:
    """MODEL frame: R = R_src R_delta; CAMERA/NAIVE frames: R = R_delta R_src."""
    if _check_coord(rot_coord) == "model":
        return torch.einsum("...ij,...jk->...ik", r_src, r_delta)
    return torch.einsum("...ij,...jk->...ik", r_delta, r_src)


def R_inv_transform(r_src: torch.Tensor, r_tgt: torch.Tensor, rot_coord: str = "CAMERA") -> torch.Tensor:
    """Rotation delta taking src to tgt: MODEL R_src^T R_tgt; CAMERA/NAIVE
    R_tgt R_src^T."""
    if _check_coord(rot_coord) == "model":
        return torch.einsum("...ji,...jk->...ik", r_src, r_tgt)
    return torch.einsum("...ij,...kj->...ik", r_tgt, r_src)


def T_transform(t_src, t_delta, t_means=0.0, t_stds=1.0, rot_coord: str = "CAMERA"):
    """Apply the untangled translation delta: z_tgt = z_src / exp(vz);
    CAMERA/MODEL: x_tgt = z_tgt (vx + x_src / z_src); CAMERA_NEW:
    x_tgt = z_src vx + x_src.  t_src, t_delta: (..., 3)."""
    rc = _check_coord(rot_coord)
    d = t_delta * t_stds + t_means
    zs = t_src[..., 2]
    z2 = zs / torch.exp(d[..., 2])
    if rc in ("camera", "model"):
        x2 = z2 * (d[..., 0] + t_src[..., 0] / zs)
        y2 = z2 * (d[..., 1] + t_src[..., 1] / zs)
    elif rc == "camera_new":
        x2 = zs * d[..., 0] + t_src[..., 0]
        y2 = zs * d[..., 1] + t_src[..., 1]
    else:
        raise ValueError("T_transform does not support rot_coord='naive'")
    return torch.stack([x2, y2, z2], dim=-1)


def T_inv_transform(t_src, t_tgt, t_means=0.0, t_stds=1.0, rot_coord: str = "CAMERA"):
    """Untangled translation delta taking t_src to t_tgt (inverse of
    T_transform), normalized by (t_means, t_stds)."""
    rc = _check_coord(rot_coord)
    if rc == "camera_new":
        vx = (t_tgt[..., 0] - t_src[..., 0]) / t_src[..., 2]
        vy = (t_tgt[..., 1] - t_src[..., 1]) / t_src[..., 2]
    elif rc in ("camera", "model"):
        vx = t_tgt[..., 0] / t_tgt[..., 2] - t_src[..., 0] / t_src[..., 2]
        vy = t_tgt[..., 1] / t_tgt[..., 2] - t_src[..., 1] / t_src[..., 2]
    else:
        raise ValueError("T_inv_transform does not support rot_coord='naive'")
    vz = torch.log(t_src[..., 2] / t_tgt[..., 2])
    delta = torch.stack([vx, vy, vz], dim=-1)
    return (delta - t_means) / t_stds


def RT_transform(pose_src, rot, t_delta, t_means=0.0, t_stds=1.0, rot_coord: str = "CAMERA"):
    """Apply a (rotation, untangled translation) delta to poses.

    rot: (..., 4) quaternion (normalized here) or (..., 3) 'sxyz' Euler
    angles; t_delta: (..., 3)."""
    rc = _check_coord(rot_coord)
    if rot.shape[-1] == 4:
        r_delta = quat2mat(quat_normalize(rot))
    elif rot.shape[-1] == 3:
        r_delta = euler2mat(rot[..., 0], rot[..., 1], rot[..., 2])
    else:
        raise ValueError(f"rot delta must have dim 3 (euler) or 4 (quat), got {tuple(rot.shape)}")
    if rc == "naive":
        return se3_mul(make_pose(r_delta, t_delta), pose_src)
    r = R_transform(pose_src[..., :3, :3], r_delta, rot_coord)
    t = T_transform(pose_src[..., :3, 3], t_delta, t_means, t_stds, rot_coord)
    return make_pose(r, t)


def calc_RT_delta(pose_src, pose_tgt, t_means=0.0, t_stds=1.0, rot_coord: str = "CAMERA"):
    """Relative (R_delta (..., 3, 3), untangled T_delta (..., 3)) from src
    to tgt poses; mat2quat converts R_delta for the QUAT head."""
    rc = _check_coord(rot_coord)
    if rc == "naive":
        rel = se3_mul(pose_tgt, se3_inverse(pose_src))
        return rel[..., :3, :3], rel[..., :3, 3]
    r_delta = R_inv_transform(pose_src[..., :3, :3], pose_tgt[..., :3, :3], rot_coord)
    t_delta = T_inv_transform(pose_src[..., :3, 3], pose_tgt[..., :3, 3], t_means, t_stds, rot_coord)
    return r_delta, t_delta
