"""The training step: render-and-compare with on-device label refresh
(PyTorch counterpart of deepim_tpu/engine/train.py).

One call runs TRAIN_ITER_SIZE inner iterations (a Python loop where the
JAX package has lax.scan).  Each inner iteration renders at the current
source pose, runs the network, computes the losses with freshly derived
labels (calc_RT_delta, flow_from_depth), back-propagates, applies one
optimizer update and carries the detached predicted pose (reset per sample
to the previous one when it is non-finite or leaves (znear, zfar)) into
the next iteration.  The renders are not differentiated: every raster
kernel is forward only, as in the JAX package.  The network computes in its
own dtype (bf16 from build_model) and hands float32 outputs to the losses,
which, like the pose update and the zooms of masks, depths and flow
labels, stay float32; gradients reach the float32 parameters through the
network's casts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from deepim_tpu_torch.config import TrainConfig, TrainIterConfig
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.engine.losses import flow_loss, mask_loss, point_matching_loss, se3_dist_loss
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation, refine_step
from deepim_tpu_torch.geometry.rotations import mat2quat
from deepim_tpu_torch.geometry.se3 import calc_RT_delta
from deepim_tpu_torch.ops.flow import flow_from_depth, gather_at_flow_target
from deepim_tpu_torch.ops.pointmatch import transform3d
from deepim_tpu_torch.ops.zoom import zoom_flow, zoom_trans
from deepim_tpu_torch.utils import tracing

# optax.apply_if_finite(max_consecutive_errors=100): the 101st consecutive
# non-finite update is applied.
MAX_CONSECUTIVE_ERRORS = 100


class TrainBatch(NamedTuple):
    """One training batch (NCHW images)."""

    image_observed: torch.Tensor     # (B, 3, H, W) RGB [0, 255]
    mask_observed: torch.Tensor      # (B, 1, H, W) strategy-applied (box_gt)
    mask_gt_observed: torch.Tensor   # (B, 1, H, W)
    depth_gt_observed: torch.Tensor  # (B, H, W) metres
    pose_rendered: torch.Tensor      # (B, 3, 4) initial (source) pose
    pose_observed: torch.Tensor      # (B, 3, 4) target pose
    class_index: torch.Tensor        # (B,) int
    points_model: torch.Tensor       # (B, N, 3) model points, zero-padded
    points_weights: torch.Tensor     # (B, N) 1 for real points
    k: torch.Tensor                  # (3, 3)
    depth_observed: torch.Tensor | None = None  # (B, 1, H, W) metres; read with input_depth

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(None if x is None else x.to(device) for x in self))


class Optimizer:
    """make_optimizer's result: optax's chain as torch.optim plus a few lines.

    sgd = add_decayed_weights(wd) then sgd(lr, momentum), which is
    torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False);
    adam = optax.adamw(lr, weight_decay=wd), which is torch.optim.AdamW
    with eps 1e-8.  grad_clip > 0 is optax.clip_by_global_norm (g kept
    below the norm, else g / norm * max_norm; no epsilon).  skip_nonfinite
    is optax.apply_if_finite: a step with a non-finite gradient leaves the
    parameters, the optimizer state and the update count untouched, up to
    MAX_CONSECUTIVE_ERRORS in a row.  The learning rate is
    schedule(count), count being the number of applied updates."""

    def __init__(self, params, tcfg: TrainConfig, schedule):
        self.params = list(params)
        self.schedule = schedule
        self.grad_clip = tcfg.grad_clip
        self.skip_nonfinite = tcfg.skip_nonfinite
        self.count = 0
        self.notfinite_count = 0
        name = tcfg.optimizer.lower()
        if name == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=schedule(0), momentum=tcfg.momentum,
                                         weight_decay=tcfg.wd, dampening=0.0, nesterov=False)
        elif name == "adam":
            self.inner = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=tcfg.wd)
        else:
            raise ValueError(f"Unknown TRAIN.optimizer {tcfg.optimizer!r}")

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """Apply one update from the parameters' .grad; returns whether it
        was applied.  A parameter without a gradient counts as a zero
        gradient (optax still decays it)."""
        with tracing.span("optim.step", self.params[0].device):
            grads = []
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if self.skip_nonfinite:
                finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
                self.notfinite_count = 0 if finite else self.notfinite_count + 1
                if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                    return False
            if self.grad_clip > 0:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                keep = norm < self.grad_clip
                for g in grads:
                    g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
            for group in self.inner.param_groups:
                group["lr"] = self.schedule(self.count)
            self.inner.step()
            self.count += 1
            return True


def make_optimizer(params, tcfg: TrainConfig, schedule) -> Optimizer:
    """TRAIN.optimizer 'sgd' (the reference recipe) or 'adam' (AdamW), with
    optional global-norm clipping and the non-finite skip."""
    return Optimizer(params, tcfg, schedule)


@dataclass
class TrainState:
    """The JAX TrainState's (params, opt_state, step): the model holds the
    parameters, the optimizer its state, and step counts inner iterations
    run (each one update, applied or skipped).  `epochs` holds the figures
    tools/train_net.train_net records for each epoch it ran."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    epochs: list[dict] = field(default_factory=list)


def flow_weights_from_valid(valid, weight_type: str, depth_src):
    """Per-channel flow weights from the visibility map.  valid, depth_src:
    (B, H, W) -> (B, 2, H, W).  'viz_visible' is 'viz' on a visibility
    already multiplied by the target's visible mask (compute_losses)."""
    if weight_type == "all":
        w = torch.ones_like(valid)
    elif weight_type == "viz":
        w = valid
    elif weight_type == "valid":
        w = ((depth_src == 0) | (valid > 0)).to(valid.dtype)
    else:
        raise ValueError(f"Unknown FLOW_WEIGHT_TYPE {weight_type}")
    return w[:, None].repeat(1, 2, 1, 1)


def compute_losses(model, batch: TrainBatch, meshes: MeshBuffers, pose_src, ecfg: EngineConfig,
                   ticfg: TrainIterConfig, flow_weight_type: str, device="cuda"):
    """One forward pass and every enabled loss at the current source pose.
    Returns (total, (pose_new, losses)); losses holds each loss, 'total'
    and 'raster_dropped' (the render's CSR truncated-pair count)."""
    dev = resolve_device(device)
    pose_new, aux = refine_step(model, Observation.from_batch(batch), meshes, pose_src, ecfg,
                                device=dev)
    with tracing.span("loss", dev):
        zf = aux["zoom_factor"]
        t_means = torch.tensor(ecfg.trans_means, dtype=torch.float32, device=dev)
        t_stds = torch.tensor(ecfg.trans_stds, dtype=torch.float32, device=dev)
        losses = {}
        total = torch.zeros((), dtype=torch.float32, device=dev)

        if ticfg.SE3_PM_LOSS:
            r_obs, t_obs = batch.pose_observed[:, :, :3], batch.pose_observed[:, :, 3]
            points_obs = torch.einsum("bij,bnj->bni", r_obs, batch.points_model) + t_obs[:, None, :]
            points_est = transform3d(batch.points_model, aux["rot"], aux["trans"], pose_src,
                                     t_means, t_stds, ecfg.rot_coord)
            pm = point_matching_loss(points_est, points_obs, batch.points_weights, ticfg,
                                     ecfg.normalize_3d_point)
            losses["pm_loss"] = pm
            total = total + pm

        if ticfg.SE3_DIST_LOSS:
            r_delta, t_delta = calc_RT_delta(pose_src, batch.pose_observed, t_means, t_stds,
                                             ecfg.rot_coord)
            zoom_trans_gt = zoom_trans(t_delta, zf.as_array(), False, False)
            rot_l, trans_l = se3_dist_loss(aux["rot"], aux["zoom_trans"], mat2quat(r_delta),
                                           zoom_trans_gt.detach(), ticfg)
            losses["rot_loss"] = rot_l
            losses["trans_loss"] = trans_l
            total = total + rot_l + trans_l

        if ecfg.pred_flow and ticfg.LW_FLOW > 0:
            depth_rend = aux["depth_rendered"][:, 0]
            gt_flow, gt_valid = flow_from_depth(
                depth_rend, batch.depth_gt_observed, pose_src, batch.pose_observed, batch.k,
                standard_rep=ecfg.standard_flow_rep,
            )
            if flow_weight_type == "viz_visible":
                vis_tgt = gather_at_flow_target(batch.mask_gt_observed[:, 0], gt_flow,
                                                standard_rep=ecfg.standard_flow_rep)
                weights = flow_weights_from_valid(gt_valid * vis_tgt, "viz", depth_rend)
            else:
                weights = flow_weights_from_valid(gt_valid, flow_weight_type, depth_rend)
            z_flow, z_weights = zoom_flow(gt_flow, zf, weights)
            fl = flow_loss(aux["net"]["flow"], z_flow, z_weights, ecfg.normalize_flow, ticfg.LW_FLOW,
                           float(ecfg.height * ecfg.width))
            losses["flow_loss"] = fl
            total = total + fl

        if ecfg.pred_mask and ticfg.LW_MASK > 0:
            ml = mask_loss(aux["net"]["mask_logit"], aux["zoom_mask_gt_observed"], ticfg.LW_MASK)
            losses["mask_loss"] = ml
            total = total + ml

        losses["total"] = total
        losses["raster_dropped"] = aux["raster_dropped"]
    return total, (pose_new, losses)


def make_train_step(ecfg: EngineConfig, ticfg: TrainIterConfig, flow_weight_type: str = "viz",
                    num_inner: int | None = None, device="cuda"):
    """Build the train step: train_step(state, batch, bank_arrays) runs
    num_inner (default ecfg.num_iters) inner iterations, each one update,
    and returns (state, metrics, pose_final); metrics maps each entry of
    compute_losses' dict to a (num_inner,) tensor."""
    n_inner = num_inner if num_inner is not None else ecfg.num_iters
    if ticfg.SE3_DIST_LOSS and ecfg.rot_type != "QUAT":
        raise ValueError("SE3_DIST_LOSS requires network.ROT_TYPE='QUAT'")
    dev = resolve_device(device)
    znear, zfar = ecfg.raster.znear, ecfg.raster.zfar

    def train_step(state: TrainState, batch: TrainBatch, bank_arrays):
        with tracing.span("train.step", dev):
            batch = batch.to(dev)
            meshes = MeshBuffers.gather(bank_arrays, batch.class_index, device=dev)
            pose_src = batch.pose_rendered
            history = []
            for _ in range(n_inner):
                with tracing.span("train.inner", dev):
                    state.optimizer.zero_grad()
                    total, (pose_new, losses) = compute_losses(
                        state.model, batch, meshes, pose_src, ecfg, ticfg, flow_weight_type, device=dev)
                    if total.requires_grad:
                        with tracing.span("net.backward", dev):
                            total.backward()
                    state.optimizer.step()
                    state.step += 1
                    pose_next = pose_new.detach()
                    z = pose_next[:, 2, 3]
                    ok = torch.isfinite(pose_next).all(dim=2).all(dim=1) & (z > znear) & (z < zfar)
                    pose_src = torch.where(ok[:, None, None], pose_next, pose_src)
                    history.append({k: v.detach() for k, v in losses.items()})
            metrics = {k: torch.stack([h[k] for h in history]) for k in history[0]}
            return state, metrics, pose_src

    return train_step
