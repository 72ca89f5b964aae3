"""Plain DeepIM zoom: the square crop around the rendered object and the
bilinear resampling of images, masks and flow into it.

A crop is the affine map (wx, wy, tx, ty) of normalised coordinates in
[-1, 1]: output pixel (i, j) samples the source at (wx gx + tx,
wy gy + ty) with g = (2 j / (W - 1) - 1, 2 i / (H - 1) - 1), pixel
(g + 1) (size - 1) / 2, bilinear, zero outside the source.
"""
from __future__ import annotations

import torch

from perfbench.reference.geometry import project_points


def mask_bbox(mask: torch.Tensor):
    """(B, H, W) -> x0, x1, y0, y1 (B,) of pixels > 0.5, and whether any."""
    m = mask > 0.5
    b, h, w = m.shape
    cols, rows = m.any(1), m.any(2)
    xs = torch.arange(w, dtype=torch.float32, device=m.device).expand(b, w)
    ys = torch.arange(h, dtype=torch.float32, device=m.device).expand(b, h)
    inf = float("inf")
    return (torch.where(cols, xs, inf).amin(1), torch.where(cols, xs, -inf).amax(1),
            torch.where(rows, ys, inf).amin(1), torch.where(rows, ys, -inf).amax(1), cols.any(1))


def box_fill(mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) -> its filled bounding box, [x0, x1) x [y0, y1)."""
    x0, x1, y0, y1, ok = mask_bbox(mask[:, 0])
    h, w = mask.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=mask.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=mask.device)[None, None, :]
    box = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None]) & (xs >= x0[:, None, None])
           & (xs < x1[:, None, None]) & ok[:, None, None])
    return box[:, None].float()


def zoom_factor(mask_real, mask_rendered, pose, k):
    """Crop of the real (gt-observed) and rendered masks (B, 1, H, W)
    around the projected object origin: half extent max(0.75 left,
    0.75 right, up, down) * 1.4, square; -> (B, 4) (wx, wy, tx, ty)."""
    h, w = mask_real.shape[-2:]
    rx0, rx1, ry0, ry1, rv = mask_bbox((mask_real[:, 0] > 0.3).float())
    sx0, sx1, sy0, sy1, sv = mask_bbox((mask_rendered[:, 0] > 0.2).float())
    rx0, rx1 = torch.where(rv, rx0, 0.0), torch.where(rv, rx1, w - 1.0)
    ry0, ry1 = torch.where(rv, ry0, 0.0), torch.where(rv, ry1, h - 1.0)
    sx0, sx1 = torch.where(sv, sx0, rx0), torch.where(sv, sx1, rx1)
    sy0, sy1 = torch.where(sv, sy0, ry0), torch.where(sv, sy1, ry1)
    center = project_points(pose[:, :, 3], k)
    cx = torch.where(sv, center[:, 0], (rx0 + rx1) * 0.5)
    cy = torch.where(sv, center[:, 1], (ry0 + ry1) * 0.5)
    half = torch.maximum(torch.maximum(0.75 * torch.maximum(sx1 - cx, rx1 - cx),
                                       0.75 * torch.maximum(cx - sx0, cx - rx0)),
                         torch.maximum(torch.maximum(cy - sy0, cy - ry0), torch.maximum(ry1 - cy, sy1 - cy)))
    crop_h = torch.clamp(half * 1.4 * 2.0, min=1e-4 * h)
    wx = crop_h / h
    return torch.stack([wx, wx, cx / w * 2.0 - 1.0, cy / h * 2.0 - 1.0], -1)


def _weights(pos: torch.Tensor, size: int) -> torch.Tensor:
    idx = torch.arange(size, dtype=torch.float32, device=pos.device)
    return torch.clamp(1.0 - torch.abs(pos[..., None] - idx), min=0.0)


def sample(img: torch.Tensor, zf: torch.Tensor) -> torch.Tensor:
    """Resample (B, C, H, W) through the crops zf (B, 4), same size out."""
    _, _, h, w = img.shape
    gx = torch.linspace(-1.0, 1.0, w, device=img.device)
    gy = torch.linspace(-1.0, 1.0, h, device=img.device)
    sx = (zf[:, 0:1] * gx + zf[:, 2:3] + 1.0) * ((w - 1) * 0.5)
    sy = (zf[:, 1:2] * gy + zf[:, 3:4] + 1.0) * ((h - 1) * 0.5)
    wy, wx = _weights(sy, h), _weights(sx, w)
    return torch.einsum("bih,bchw,bjw->bcij", wy, img, wx)


def zoom_flow(flow, zf, weights):
    """Flow labels (B, 2, H, W) into the crop, values / wx; the weights
    zoomed and re-binarised by round(x - 0.45)."""
    out = sample(flow, zf) / zf[:, 0, None, None, None]
    return out, torch.round(sample(weights, zf) - 0.45)
