"""DeepIM zoom-in crop ops, batched (PyTorch counterpart of
deepim_tpu/ops/zoom.py).

The crop is non-differentiable (the zoom factor is detached), except
zoom_trans, which passes gradients through to the translation.  zoom_flow
zooms the training flow labels and their weights.  Only the images may be
zoomed in bf16 (EngineConfig.zoom_dtype); masks, depths and flow labels,
and the foreground thresholds of zoom_factor_from_images, stay float32.
"""
from __future__ import annotations

import torch

from deepim_tpu_torch.geometry.projection import project_points
from deepim_tpu_torch.ops.sampler import ZoomFactor, affine_sample, invert_zoom_factor

MASK_THRESH = 0.2  # depth-as-mask binarization


def mask_bbox(mask: torch.Tensor):
    """Bbox of nonzero pixels of (B, H, W) -> (x0, x1, y0, y1, valid), each
    (B,); empty masks give x0 > x1 (inf / -inf) and valid False."""
    m = mask > 0.5
    b, h, w = m.shape
    col_any = m.any(dim=-2)  # (B, W)
    row_any = m.any(dim=-1)  # (B, H)
    xs = torch.arange(w, dtype=torch.float32, device=m.device).expand(b, w)
    ys = torch.arange(h, dtype=torch.float32, device=m.device).expand(b, h)
    inf = torch.tensor(float("inf"), device=m.device)
    x0 = torch.where(col_any, xs, inf).amin(-1)
    x1 = torch.where(col_any, xs, -inf).amax(-1)
    y0 = torch.where(row_any, ys, inf).amin(-1)
    y1 = torch.where(row_any, ys, -inf).amax(-1)
    return x0, x1, y0, y1, col_any.any(-1)


def _zoom_factor_from_boxes(real_box, rend_box, rend_center, height: int, width: int) -> ZoomFactor:
    """Crop center = projected rendered-object center (observed bbox center
    when the render is empty); half-extent = max(0.75 l, 0.75 r, u, d) * 1.4;
    square in normalized units."""
    rx0, rx1, ry0, ry1, r_valid = real_box
    sx0, sx1, sy0, sy1, s_valid = rend_box
    rx0 = torch.where(r_valid, rx0, 0.0)
    rx1 = torch.where(r_valid, rx1, float(width - 1))
    ry0 = torch.where(r_valid, ry0, 0.0)
    ry1 = torch.where(r_valid, ry1, float(height - 1))
    real_cx = (rx0 + rx1) * 0.5
    real_cy = (ry0 + ry1) * 0.5
    sx0 = torch.where(s_valid, sx0, rx0)
    sx1 = torch.where(s_valid, sx1, rx1)
    sy0 = torch.where(s_valid, sy0, ry0)
    sy1 = torch.where(s_valid, sy1, ry1)
    cx = torch.where(s_valid, rend_center[..., 0], real_cx)
    cy = torch.where(s_valid, rend_center[..., 1], real_cy)
    left = torch.maximum(cx - sx0, cx - rx0)
    right = torch.maximum(sx1 - cx, rx1 - cx)
    up = torch.maximum(cy - sy0, cy - ry0)
    down = torch.maximum(ry1 - cy, sy1 - cy)
    crop_h = (
        torch.maximum(torch.maximum(0.75 * right, 0.75 * left), torch.maximum(up, down))
        * 1.4
        * 2.0
    )
    crop_h = torch.clamp(crop_h, min=1e-4 * height)
    wx = crop_h / height
    zf = ZoomFactor(wx=wx, wy=wx, tx=cx / width * 2.0 - 1.0, ty=cy / height * 2.0 - 1.0)
    return ZoomFactor(*(v.detach() for v in zf))


def zoom_factor_from_masks(mask_observed, mask_gt_observed, mask_rendered, src_pose, k) -> ZoomFactor:
    """Zoom factor from the gt-observed and rendered masks plus the
    projected object center.  masks: (B, 1, H, W); src_pose: (B, 3, 4);
    k: (3, 3).  The rendered mask is binarized at 0.2 first."""
    _, _, h, w = mask_observed.shape
    real = mask_gt_observed.sum(1) > 0.3
    rend = torch.where(mask_rendered > MASK_THRESH, 1.0, 0.0).sum(1) > 0.3
    center = project_points(src_pose[:, :, 3], k)
    return _zoom_factor_from_boxes(mask_bbox(real), mask_bbox(rend), center, h, w)


def zoom_factor_from_images(image_observed, image_rendered, src_pose, k, pixel_means) -> ZoomFactor:
    """Zoom factor from the image foregrounds (the INPUT_MASK=False path):
    foreground = channel sum of (image + mean) > 0.01, in float32.
    Images: (B, 3, H, W) mean-subtracted; src_pose: (B, 3, 4); k: (3, 3)."""
    _, _, h, w = image_observed.shape
    pm = pixel_means.reshape(1, -1, 1, 1)
    real = (image_observed + pm).sum(1) > 0.01
    rend = (image_rendered + pm).sum(1) > 0.01
    center = project_points(src_pose[:, :, 3], k)
    return _zoom_factor_from_boxes(mask_bbox(real), mask_bbox(rend), center, h, w)


def zoom_images(image_observed, image_rendered, zf: ZoomFactor, pixel_means):
    """Zoom a mean-subtracted image pair; means are added back before
    sampling and removed after, so out-of-frame pixels end at -mean.  The
    means take the images' dtype (bf16 for the bf16 zoom)."""
    pm = pixel_means.reshape(1, -1, 1, 1).to(image_observed.dtype)
    obs = affine_sample(image_observed + pm, zf) - pm
    rend = affine_sample(image_rendered + pm, zf) - pm
    return obs.detach(), rend.detach()


def zoom_depths(depth_observed, depth_rendered, zf: ZoomFactor):
    """Zoom a depth pair (B, 1, H, W); no gradient."""
    return affine_sample(depth_observed, zf).detach(), affine_sample(depth_rendered, zf).detach()


def zoom_mask(mask, zf: ZoomFactor, *, binarize_input: bool = True, inverse: bool = False):
    """(Inverse) zoom of a mask: binarize at 0.2 first, round after."""
    if binarize_input:
        mask = torch.where(mask > MASK_THRESH, 1.0, 0.0).to(mask.dtype)
    if inverse:
        zf = invert_zoom_factor(zf, mask.shape[-2], mask.shape[-1])
    return torch.round(affine_sample(mask, zf)).detach()


def zoom_masks(mask_observed, mask_gt_observed, mask_rendered, zf: ZoomFactor):
    """Observed and gt-observed sampled raw, rendered sampled after
    0.2-binarization; all rounded."""
    obs = torch.round(affine_sample(mask_observed, zf))
    gt = torch.round(affine_sample(mask_gt_observed, zf))
    rend_bin = torch.where(mask_rendered > MASK_THRESH, 1.0, 0.0).to(mask_rendered.dtype)
    rend = torch.round(affine_sample(rend_bin, zf))
    return obs.detach(), gt.detach(), rend.detach()


def zoom_flow(flow, zf: ZoomFactor, flow_weights=None, *, inverse: bool = False):
    """(Inverse) zoom of flow maps (B, 2, H, W), scaling the flow values by
    1/wx (inverse: by wx).  The forward zoom also zooms the flow weights and
    re-binarizes them with round(x - 0.45), returning (flow, weights).  No
    gradient."""
    h, w = flow.shape[-2], flow.shape[-1]
    sample_zf = invert_zoom_factor(zf, h, w) if inverse else zf
    scale = zf.wx if inverse else 1.0 / zf.wx
    out = (affine_sample(flow, sample_zf) * scale[:, None, None, None]).detach()
    if inverse:
        return out
    if flow_weights is None:
        raise ValueError("forward zoom_flow requires flow_weights")
    zw = torch.round(affine_sample(flow_weights, sample_zf) - 0.45).detach()
    return out, zw


def _zoom_trans_math(trans_delta, wx, inverse: bool):
    scale = wx if inverse else 1.0 / wx
    return torch.stack(
        [trans_delta[..., 0] * scale, trans_delta[..., 1] * scale, trans_delta[..., 2]], dim=-1
    )


class _ZoomTrans(torch.autograd.Function):
    """Forward scales (vx, vy) by the zoom; backward passes the gradient
    through unscaled unless zoom_grad, and gives the zoom factor none."""

    @staticmethod
    def forward(ctx, trans_delta, zf_arr, inverse, zoom_grad):
        ctx.save_for_backward(zf_arr)
        ctx.inverse, ctx.zoom_grad = inverse, zoom_grad
        return _zoom_trans_math(trans_delta, zf_arr[..., 0].detach(), inverse)

    @staticmethod
    def backward(ctx, g):
        (zf_arr,) = ctx.saved_tensors
        if ctx.zoom_grad:
            wx = zf_arr[..., 0]
            scale = wx if ctx.inverse else 1.0 / wx
            gx, gy = g[..., 0] * scale, g[..., 1] * scale
        else:
            gx, gy = g[..., 0], g[..., 1]
        return torch.stack([gx, gy, g[..., 2]], dim=-1), torch.zeros_like(zf_arr), None, None


def zoom_trans(trans_delta, zf_arr, inverse: bool = False, zoom_grad: bool = False):
    """Scale the (vx, vy) translation delta by the zoom: zoom-in divides by
    wx, inverse multiplies.  trans_delta: (B, 3); zf_arr: (B, 4)."""
    return _ZoomTrans.apply(trans_delta, zf_arr, inverse, zoom_grad)
