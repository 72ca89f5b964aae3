"""Flow from depth: ground-truth optical flow between a rendered-depth frame
and a target-depth frame by reprojection plus a depth-consistency
visibility test (PyTorch counterpart of deepim_tpu/ops/flow.py).

Channel order follows the reference's default (STANDARD_FLOW_REP=False):
channel 0 = dh, channel 1 = dw; standard_rep=True gives [dw, dh].
"""
from __future__ import annotations

import torch

from deepim_tpu_torch.geometry.projection import pixel_grid
from deepim_tpu_torch.geometry.se3 import se3_inverse, se3_mul

DEPTH_EPS = 1e-3    # source-depth validity
VIS_THRESH = 3e-3   # depth-consistency visibility


def _gather_hw(values, h_c, w_c):
    """values (B, H, W) at integer (h_c, w_c) (B, H, W) -> (B, H, W)."""
    b, h, w = values.shape
    flat = (h_c * w + w_c).reshape(b, h * w)
    return torch.gather(values.reshape(b, h * w), 1, flat).reshape(b, h, w)


def flow_from_depth_kt(depth_src, depth_tgt, kt, k_inv, *, thresh: float = VIS_THRESH,
                       standard_rep: bool = False):
    """Batched flow from a depth pair and projection matrices.

    depth_src, depth_tgt: (B, H, W); kt: (B, 3, 4) = K [R|t]_rel; k_inv:
    (3, 3).  Returns (flow (B, 2, H, W), valid (B, H, W)): a pixel is valid
    iff its source depth > 1e-3, the reprojection lands in frame, and the
    projected depth agrees with the target depth within `thresh`."""
    b, h, w = depth_src.shape
    hh, ww = pixel_grid(h, w, depth_src.dtype, depth_src.device)
    x = (ww * k_inv[0, 0] + hh * k_inv[0, 1] + k_inv[0, 2]) * depth_src
    y = (ww * k_inv[1, 0] + hh * k_inv[1, 1] + k_inv[1, 2]) * depth_src
    z = depth_src

    def dot_row(r):
        c = kt[:, r, :, None, None]
        return x * c[:, 0] + y * c[:, 1] + z * c[:, 2] + c[:, 3]

    x_proj = dot_row(0)
    y_proj = dot_row(1)
    z_proj = dot_row(2) + 1e-15
    w_proj = x_proj / z_proj
    h_proj = y_proj / z_proj
    in_frame = (w_proj >= 0.0) & (w_proj <= w - 1.0) & (h_proj >= 0.0) & (h_proj <= h - 1.0)
    w_c = torch.clamp(torch.round(w_proj).to(torch.int64), 0, w - 1)
    h_c = torch.clamp(torch.round(h_proj).to(torch.int64), 0, h - 1)
    d_tgt = _gather_hw(depth_tgt, h_c, w_c)
    valid = (depth_src > DEPTH_EPS) & in_frame & (torch.abs(z_proj - d_tgt) < thresh)
    zero = torch.zeros_like(h_proj)
    dh = torch.where(valid, h_proj - hh, zero)
    dw = torch.where(valid, w_proj - ww, zero)
    flow = torch.stack([dw, dh] if standard_rep else [dh, dw], dim=1)
    return flow, valid.to(depth_src.dtype)


def gather_at_flow_target(values, flow, *, standard_rep: bool = False):
    """Nearest-neighbour sample of values (B, H, W) at each source pixel's
    flow target; flow (B, 2, H, W) in the configured channel order.  Used
    for occlusion-aware flow weights (FLOW_WEIGHT_TYPE 'viz_visible')."""
    _, _, h, w = flow.shape
    hh, ww = pixel_grid(h, w, flow.dtype, flow.device)
    dh = flow[:, 1] if standard_rep else flow[:, 0]
    dw = flow[:, 0] if standard_rep else flow[:, 1]
    h_c = torch.clamp(torch.round(hh + dh).to(torch.int64), 0, h - 1)
    w_c = torch.clamp(torch.round(ww + dw).to(torch.int64), 0, w - 1)
    return _gather_hw(values, h_c, w_c)


def flow_from_depth(depth_src, depth_tgt, pose_src, pose_tgt, k, *, thresh: float = VIS_THRESH,
                    standard_rep: bool = False):
    """Flow from depths and poses: KT = K (pose_tgt pose_src^-1).
    k: (3, 3).  Returns (flow (B, 2, H, W), valid (B, H, W))."""
    rel = se3_mul(pose_tgt, se3_inverse(pose_src))
    kt = torch.einsum("ij,bjk->bik", k, rel)
    k_inv = torch.linalg.inv(k)
    return flow_from_depth_kt(depth_src, depth_tgt, kt, k_inv, thresh=thresh,
                              standard_rep=standard_rep)
