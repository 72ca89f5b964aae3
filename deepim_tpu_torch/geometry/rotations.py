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


def qmult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 q2, sign-normalized to w >= 0."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    q = torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        dim=-1,
    )
    return torch.where(q[..., :1] < 0, -q, q)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Quaternion inverse, conj(q) / |q|^2 with |q|^2 floored at 1e-12."""
    nq = torch.sum(q * q, dim=-1, keepdim=True)
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return conj / torch.clamp(nq, min=_EPS)


def mat2euler(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation matrices -> Euler 'sxyz' angles (ai, aj, ak), branchless: at
    gimbal lock (cy <= 4 eps of the dtype) ai takes the degenerate formula
    and ak is 0."""
    cy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    regular = cy > 4.0 * torch.finfo(m.dtype).eps
    ax = torch.where(regular, torch.atan2(m[..., 2, 1], m[..., 2, 2]), torch.atan2(-m[..., 1, 2], m[..., 1, 1]))
    ay = torch.atan2(-m[..., 2, 0], cy)
    az = torch.where(regular, torch.atan2(m[..., 1, 0], m[..., 0, 0]), torch.zeros_like(cy))
    return ax, ay, az


def rot_geodesic_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations in degrees, arccos((tr(R1^T R2) - 1)
    / 2) with the cosine clipped to [-1, 1].  (..., 3, 3) x (..., 3, 3) ->
    (...,)."""
    if r1.dtype == torch.float32:
        # Each diagonal entry of R1^T R2 rounded as XLA's CPU compiler
        # rounds the JAX package's float32 3x3 product: fma(a2, b2, fma(a1,
        # b1, a0 b0)).  arccos's slope turns one ulp of the cosine into
        # 1e-5 deg at a few degrees; so the port and the JAX package agree.
        # A float32 product is exact in float64, so the float64 sum rounded
        # to float32 is the FMA's result.
        a, b = r1.double(), r2.double()
        diag = (r1[..., 0, :] * r2[..., 0, :]).double()
        diag = (a[..., 1, :] * b[..., 1, :] + diag).float().double()
        diag = (a[..., 2, :] * b[..., 2, :] + diag).float()
    else:
        diag = torch.einsum("...ji,...ji->...i", r1, r2)
    tr = diag[..., 0] + diag[..., 1] + diag[..., 2]
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)))


def quat_angle_deg(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle between unit quaternions in degrees, arccos(2 (q1.q2)^2 - 1)."""
    d = torch.sum(q1 * q2, dim=-1)
    return torch.rad2deg(torch.arccos(torch.clamp(2.0 * d * d - 1.0, -1.0, 1.0)))
