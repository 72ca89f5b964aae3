"""Training losses with the reference's loss scales (PyTorch counterpart of
deepim_tpu/engine/losses.py).

MXNet MakeLoss(data, grad_scale=g) back-propagates g * d(sum(data)), so
each loss here is g * sum(...), divided by the batch size (the reference
folds 1/batch into the optimizer's rescale_grad):

* flow: LW_FLOW / (H*W) * sum(weights * (flow_est - flow_gt / NF)^2);
* point matching: LW_PM / NUM_3D_SAMPLE * sum(w * |dp| / NORMALIZE_3D_POINT);
* mask: LW_MASK * sum(BCE(logit, label));
* optional SE(3) distance: rotation 1 - (q_gt . q_est)^2, translation
  L2 / L1 / smooth L1 on the zoomed delta.

Labels are detached where the JAX package stops gradients.
"""
from __future__ import annotations

import torch

from deepim_tpu_torch.config import TrainIterConfig


def smooth_l1(x, scalar: float):
    """MXNet smooth_l1 with sigma `scalar`: 0.5 (s x)^2 if |x| < 1/s^2,
    else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def flow_loss(flow_est, flow_gt, flow_weights, normalize_flow: float, lw_flow: float,
              frame_pixels: float):
    """flow_est, flow_gt, flow_weights: (B, 2, H, W); flow_gt in pixels,
    flow_est in normalized units."""
    b = flow_est.shape[0]
    err = flow_weights * torch.square(flow_est - flow_gt / normalize_flow)
    return lw_flow / frame_pixels * torch.sum(err) / b


def point_matching_loss(points_est, points_obs, point_weights, ticfg: TrainIterConfig,
                        normalize_3d_point: float):
    """points_*: (B, N, 3); point_weights: (B, N) or (B, N, 1)."""
    b = points_est.shape[0]
    if point_weights.dim() == 2:
        point_weights = point_weights[..., None]
    d = (points_est - points_obs.detach()) / normalize_3d_point
    if ticfg.SE3_PM_LOSS_TYPE == "L1":
        e = torch.abs(d)
    elif ticfg.SE3_PM_LOSS_TYPE == "L2":
        e = torch.square(d)
    elif ticfg.SE3_PM_LOSS_TYPE == "smooth_L1":
        e = smooth_l1(d, ticfg.SE3_PM_SL1_SCALAR)
    else:
        raise ValueError(f"Unknown SE3_PM_LOSS_TYPE {ticfg.SE3_PM_LOSS_TYPE}")
    return ticfg.LW_PM / ticfg.NUM_3D_SAMPLE * torch.sum(point_weights * e) / b


def mask_loss(mask_logit, mask_label, lw_mask: float):
    """Per-pixel binary cross entropy with logits, summed; (B, 1, H, W)."""
    b = mask_logit.shape[0]
    label = mask_label.detach()
    bce = (torch.clamp(mask_logit, min=0) - mask_logit * label
           + torch.log1p(torch.exp(-torch.abs(mask_logit))))
    return lw_mask * torch.sum(bce) / b


def se3_dist_loss(rot_est, zoom_trans_est, rot_gt, zoom_trans_gt, ticfg: TrainIterConfig):
    """Direct SE(3) losses: rotation 1 - (q_gt . q_est)^2; translation on
    the zoomed delta.  Returns (rot_loss, trans_loss)."""
    b = rot_est.shape[0]
    dot = torch.sum(rot_gt * rot_est, dim=-1)
    rot_l = ticfg.LW_ROT * torch.sum(1.0 - torch.square(dot)) / b
    d = zoom_trans_est - zoom_trans_gt
    if ticfg.TRANS_LOSS_TYPE == "L2":
        e = torch.square(d)
    elif ticfg.TRANS_LOSS_TYPE == "L1":
        e = torch.abs(d)
    elif ticfg.TRANS_LOSS_TYPE == "smooth_L1":
        e = smooth_l1(d, ticfg.TRANS_SMOOTH_L1_SCALAR)
    else:
        raise ValueError(f"Unknown TRANS_LOSS_TYPE {ticfg.TRANS_LOSS_TYPE}")
    trans_l = ticfg.LW_TRANS * torch.sum(e) / b
    return rot_l, trans_l
