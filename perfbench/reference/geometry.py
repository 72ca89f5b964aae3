"""Plain SE(3) arithmetic of DeepIM's refinement: the quaternion head's
rotation, the untangled translation delta (camera frame), the pose update
and ground-truth flow from a rendered depth."""
from __future__ import annotations

import torch


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """(B, 4) quaternions (w, x, y, z), any norm -> (B, 3, 3)."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.clamp(w * w + x * x + y * y + z * z, min=1e-12)
    return torch.stack([
        1.0 - (y * y + z * z) * s, (x * y - w * z) * s, (x * z + w * y) * s,
        (x * y + w * z) * s, 1.0 - (x * x + z * z) * s, (y * z - w * x) * s,
        (x * z - w * y) * s, (y * z + w * x) * s, 1.0 - (x * x + y * y) * s,
    ], -1).reshape(q.shape[:-1] + (3, 3))


def apply_delta(pose: torch.Tensor, quat: torch.Tensor, t_delta: torch.Tensor) -> torch.Tensor:
    """Camera-frame update: R = R_delta R_src; z = z_src / exp(vz),
    (x, y) = z (v_xy + (x, y)_src / z_src)."""
    r = quat2mat(quat) @ pose[:, :, :3]
    t_src = pose[:, :, 3]
    z = t_src[:, 2] / torch.exp(t_delta[:, 2])
    x = z * (t_delta[:, 0] + t_src[:, 0] / t_src[:, 2])
    y = z * (t_delta[:, 1] + t_src[:, 1] / t_src[:, 2])
    return torch.cat([r, torch.stack([x, y, z], -1)[:, :, None]], -1)


def project_points(points: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, 3) camera points -> (B, 2) pixels (u, v)."""
    p = points @ k.T
    return p[:, :2] / p[:, 2:3]


def relative(pose_src: torch.Tensor, pose_tgt: torch.Tensor) -> torch.Tensor:
    """pose_tgt pose_src^-1 as (B, 3, 4)."""
    r_inv = pose_src[:, :, :3].transpose(1, 2)
    r = pose_tgt[:, :, :3] @ r_inv
    t = pose_tgt[:, :, 3] - (r @ pose_src[:, :, 3:4])[:, :, 0]
    return torch.cat([r, t[:, :, None]], -1)


def flow_from_depth(depth_src, depth_tgt, pose_src, pose_tgt, k):
    """Flow of each rendered pixel to the target frame, channels (dh, dw),
    and its validity: source depth > 1e-3, landing in frame, and the
    projected depth within 3 mm of the target depth at the nearest pixel.
    depth_*: (B, H, W)."""
    b, h, w = depth_src.shape
    kt = k @ relative(pose_src, pose_tgt)
    k_inv = torch.linalg.inv(k)
    hh = torch.arange(h, dtype=torch.float32, device=depth_src.device)[:, None].expand(h, w)
    ww = torch.arange(w, dtype=torch.float32, device=depth_src.device)[None, :].expand(h, w)
    x = (ww * k_inv[0, 0] + hh * k_inv[0, 1] + k_inv[0, 2]) * depth_src
    y = (ww * k_inv[1, 0] + hh * k_inv[1, 1] + k_inv[1, 2]) * depth_src
    z = depth_src
    rows = [x * kt[:, r, 0, None, None] + y * kt[:, r, 1, None, None] + z * kt[:, r, 2, None, None]
            + kt[:, r, 3, None, None] for r in range(3)]
    zp = rows[2] + 1e-15
    wp, hp = rows[0] / zp, rows[1] / zp
    in_frame = (wp >= 0) & (wp <= w - 1.0) & (hp >= 0) & (hp <= h - 1.0)
    wc = torch.clamp(torch.round(wp).long(), 0, w - 1)
    hc = torch.clamp(torch.round(hp).long(), 0, h - 1)
    d_tgt = torch.gather(depth_tgt.reshape(b, -1), 1, (hc * w + wc).reshape(b, -1)).reshape(b, h, w)
    valid = (depth_src > 1e-3) & in_frame & (torch.abs(zp - d_tgt) < 3e-3)
    flow = torch.stack([torch.where(valid, hp - hh, 0.0), torch.where(valid, wp - ww, 0.0)], 1)
    return flow, valid.float()
