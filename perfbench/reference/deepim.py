"""Plain DeepIM: test-time refinement and the training step, float32,
built from this folder's renderer, zoom, network and geometry.

`spec` holds the configuration's numbers (perfbench/configs/*.json):
height, width, k (3, 3), znear, zfar, pixel_means, normalize_flow,
normalize_3d_point, the loss weights, num_3d_sample and the optimizer's
lr, warmup_lr, warmup_step, momentum, wd and grad_clip.  The camera-frame
quaternion head, box masks and untangled translation with zero means and
unit deviations are the only options (those of the configurations run).
"""
from __future__ import annotations

import torch

from perfbench.reference import net
from perfbench.reference.geometry import apply_delta, flow_from_depth
from perfbench.reference.render import render
from perfbench.reference.zoom import box_fill, sample, zoom_factor, zoom_flow

MASK_THRESH = 0.2


def _render(spec, mesh, pose):
    rgb, depth = render(mesh["vertices"], mesh["colors"], mesh["faces"], mesh["face_valid"], pose, spec["k"],
                        spec["height"], spec["width"], spec["znear"], spec["zfar"])
    return rgb, depth, (depth > MASK_THRESH).float()


def _network_input(spec, image_obs, rgb, mask_obs, mask_rend, zf):
    pm = spec["pixel_means"].reshape(1, 3, 1, 1)
    z_obs = sample(image_obs, zf) - pm
    z_rend = sample(rgb, zf) - pm
    return torch.cat([z_obs / 255.0, z_rend / 255.0, torch.round(sample(mask_obs, zf)),
                      torch.round(sample(mask_rend, zf))], 1)


def _trans_full(trans, zf):
    """The zoomed translation back in full-frame units: (vx, vy) times
    wx; the gradient passes through unscaled."""
    scaled = trans * torch.stack([zf[:, 0], zf[:, 0], torch.ones_like(zf[:, 0])], -1)
    return trans + (scaled - trans).detach()


@torch.no_grad()
def refine(params, spec, mesh, image_obs, pose0, num_iters: int, quant=None):
    """Refine poses (B, 3, 4) against observed images (B, 3, H, W) in
    [0, 255]; box_rendered masks.  Returns the poses after each
    iteration, (num_iters, B, 3, 4)."""
    pose, poses = pose0, []
    for _ in range(num_iters):
        rgb, _, mask_rend = _render(spec, mesh, pose)
        mask_obs = box_fill(mask_rend)
        zf = zoom_factor(mask_obs, mask_rend, pose, spec["k"])
        out = net.forward(params, _network_input(spec, image_obs, rgb, mask_obs, mask_rend, zf), False, quant)
        pose = apply_delta(pose, out["rot"], _trans_full(out["trans"], zf))
        poses.append(pose)
    return torch.stack(poses)


def losses(params, spec, mesh, batch, pose_src, quant=None):
    """One forward pass at pose_src: (total, dict of pm/flow/mask/total
    losses, the predicted pose).  box_gt masks, 'viz' flow weights."""
    b = pose_src.shape[0]
    k = spec["k"]
    with torch.no_grad():
        rgb, depth, mask_rend = _render(spec, mesh, pose_src)
        zf = zoom_factor(batch["mask_gt_observed"], mask_rend, pose_src, k)
        x = _network_input(spec, batch["image_observed"], rgb, batch["mask_observed"], mask_rend, zf)
        z_mask_gt = torch.round(sample(batch["mask_gt_observed"], zf))
        flow_gt, valid = flow_from_depth(depth[:, 0], batch["depth_gt_observed"], pose_src, batch["pose_gt"], k)
        z_flow, z_w = zoom_flow(flow_gt, zf, valid[:, None].repeat(1, 2, 1, 1))
    out = net.forward(params, x, True, quant)
    pose_new = apply_delta(pose_src, out["rot"], _trans_full(out["trans"], zf))
    pts = batch["points_model"]
    p_obs = pts @ batch["pose_gt"][:, :, :3].transpose(1, 2) + batch["pose_gt"][:, None, :, 3]
    p_est = pts @ pose_new[:, :, :3].transpose(1, 2) + pose_new[:, None, :, 3]
    w = batch["points_weights"][..., None]
    pm = spec["LW_PM"] / spec["NUM_3D_SAMPLE"] * torch.sum(w * torch.abs((p_est - p_obs) / spec["normalize_3d_point"])) / b
    fl = spec["LW_FLOW"] / float(spec["height"] * spec["width"]) * torch.sum(
        z_w * torch.square(out["flow"] - z_flow / spec["normalize_flow"])) / b
    logit = out["mask_logit"]
    bce = torch.clamp(logit, min=0) - logit * z_mask_gt + torch.log1p(torch.exp(-torch.abs(logit)))
    ml = spec["LW_MASK"] * torch.sum(bce) / b
    total = pm + fl + ml
    return total, {"pm_loss": pm, "flow_loss": fl, "mask_loss": ml, "total": total}, pose_new


class SGD:
    """The recipe's optimizer on a parameter dict: global-norm clipping,
    weight decay added to the gradient, momentum (the first update's
    buffer is its gradient), a constant warm-up learning rate for the
    first warmup_step updates, then lr."""

    def __init__(self, params: dict, spec: dict):
        self.params, self.spec = params, spec
        self.buf: dict[str, torch.Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self):
        s = self.spec
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in self.params.items()}
        if s["grad_clip"] > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if norm >= s["grad_clip"]:
                grads = {n: g / norm * s["grad_clip"] for n, g in grads.items()}
        lr = s["warmup_lr"] if self.count < s["warmup_step"] else s["lr"]
        for n, p in self.params.items():
            d = grads[n] + s["wd"] * p
            self.buf[n] = d.clone() if n not in self.buf else s["momentum"] * self.buf[n] + d
            p -= lr * self.buf[n]
            p.grad = None
        self.count += 1


def train_call(opt: SGD, spec, mesh, batch, num_inner: int, quant=None) -> dict:
    """One training call: num_inner render-and-update iterations from the
    batch's initial pose, each predicted pose carried into the next unless
    it is non-finite or leaves (znear, zfar).  Returns each loss per inner
    iteration, (num_inner,)."""
    pose_src = batch["pose0"]
    hist = []
    for _ in range(num_inner):
        total, parts, pose_new = losses(opt.params, spec, mesh, batch, pose_src, quant)
        total.backward()
        opt.step()
        pose_new = pose_new.detach()
        z = pose_new[:, 2, 3]
        ok = torch.isfinite(pose_new).all(2).all(1) & (z > spec["znear"]) & (z < spec["zfar"])
        pose_src = torch.where(ok[:, None, None], pose_new, pose_src)
        hist.append({n: v.detach() for n, v in parts.items()})
    return {n: torch.stack([h[n] for h in hist]) for n in hist[0]}
