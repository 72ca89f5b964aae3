"""Batched rotation representations (PyTorch counterpart of
deepim_tpu/geometry/rotations.py).

All functions accept arbitrary leading batch dimensions.  Quaternions are
(w, x, y, z).
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. q: (..., 4)."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) -> rotation matrices; accepts un-normalized input
    (scales by 2/Nq).  q: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    nq = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp(nq, min=_EPS)
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    xx, xy, xz = x * x * s, x * y * s, x * z * s
    yy, yz, zz = y * y * s, y * z * s, z * z * s
    m = torch.stack(
        [
            1.0 - (yy + zz), xy - wz, xz + wy,
            xy + wz, 1.0 - (xx + zz), yz - wx,
            xz - wy, yz + wx, 1.0 - (xx + yy),
        ],
        dim=-1,
    ).reshape(q.shape[:-1] + (3, 3))
    # Degenerate all-zero quaternion -> identity.
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(m.shape)
    return torch.where((nq < _EPS)[..., None, None], eye, m)


def mat2quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> unit quaternions with w >= 0 (branchless
    largest-pivot extraction).  m: (..., 3, 3) -> (..., 4)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    sw = safe_sqrt(tw) * 2.0
    sx = safe_sqrt(tx) * 2.0
    sy = safe_sqrt(ty) * 2.0
    sz = safe_sqrt(tz) * 2.0
    cands = torch.stack(
        [
            torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
            torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
            torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1),
            torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx).squeeze(-2))
    return torch.where(q[..., :1] < 0, -q, q)


def euler2mat(ai: torch.Tensor, aj: torch.Tensor, ak: torch.Tensor) -> torch.Tensor:
    """Euler 'sxyz' angles -> rotation matrices, R = Rz(ak) Ry(aj) Rx(ai)."""
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return torch.stack(
        [
            cj * ck, sj * sc - cs, sj * cc + ss,
            cj * sk, sj * ss + cc, sj * cs - sc,
            -sj, cj * si, cj * ci,
        ],
        dim=-1,
    ).reshape(si.shape + (3, 3))
