"""Separable affine bilinear resampling (PyTorch counterpart of
deepim_tpu/ops/sampler.py).

DeepIM's zooms are axis-aligned affine maps ([[wx, 0, tx], [0, wy, ty]]),
so the bilinear resample factorizes into a row and a column interpolation:
out[b, c] = Wy[b] @ img[b, c] @ Wx[b]^T, with at most 2 non-zeros per row
of Wy (H_out, H_in) and Wx (W_out, W_in).  Conventions follow MXNet's
BilinearSampler: normalized coordinates in [-1, 1], pixel =
(g + 1) (size - 1) / 2 (align corners), zero padding outside the source.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ZoomFactor(NamedTuple):
    """Batched affine zoom (wx, wy, tx, ty), each (B,)."""

    wx: torch.Tensor
    wy: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor

    def as_array(self) -> torch.Tensor:
        return torch.stack(tuple(self), dim=-1)


def invert_zoom_factor(zf: ZoomFactor, height: int, width: int) -> ZoomFactor:
    """Zoom factor mapping the crop back to the full frame."""
    crop_w = zf.wx * width
    crop_h = zf.wy * height
    cx = _fma32(zf.tx * 0.5, width, 0.5 * width)
    cy = _fma32(zf.ty * 0.5, height, 0.5 * height)
    return ZoomFactor(
        wx=1.0 / zf.wx,
        wy=1.0 / zf.wy,
        tx=(width * 0.5 - cx) / crop_w * 2.0,
        ty=(height * 0.5 - cy) / crop_h * 2.0,
    )


def _grid(n: int, device) -> torch.Tensor:
    """n points on [-1, 1], rounded as the reference computes them in
    float32: jnp.linspace's start (1 - s) + stop s, with XLA's rewrite of
    s = i / (n - 1) into i * float32(1 / (n - 1)), endpoint appended.
    torch.linspace differs in the last ulp of about half the points."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    div = n - 1
    recip = torch.tensor(1.0 / div, dtype=torch.float32, device=device)
    step = torch.arange(div, dtype=torch.float32, device=device) * recip
    out = -(1.0 - step) + step
    return torch.cat([out, torch.ones(1, device=device)])


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA's CPU compiler emits the
    reference's multiply-adds here (it contracts them into FMAs:
    vfmadd213ss in the compiled coordinate fusion).  The float32 product is
    exact in float64, so the float64 sum rounded to float32 is the FMA's
    result (a double rounding could differ only on an exact float32 tie).
    b and c: tensors or Python numbers."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (f64(a) * f64(b) + f64(c)).float()


def _interp_weights(src: torch.Tensor, size_in: int) -> torch.Tensor:
    """(B, N_out) source pixel positions -> (B, N_out, size_in) bilinear
    weights (rows of out-of-range positions sum to < 1: zero padding)."""
    idx = torch.arange(size_in, dtype=src.dtype, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - idx), min=0.0)


def affine_sample(img: torch.Tensor, zf: ZoomFactor, out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Resample img (B, C, H, W) through the zoom -> (B, C, H_out, W_out).

    Output pixel (i, j) samples normalized source coordinate
    (wx gx + tx, wy gy + ty), g = (2j/(W_out-1) - 1, 2i/(H_out-1) - 1).
    Positions and weights are built in float32 and the weight matrices
    then rounded to img's dtype; both products run in float32 on those
    operands (for a bf16 image: bf16 x bf16 with a float32 result, then
    that float32 result times the bf16 weights, as JAX's
    preferred_element_type gives) and the result is rounded to img's
    dtype once, on the card as on the CPU."""
    b, c, h, w = img.shape
    ho, wo = out_hw if out_hw is not None else (h, w)
    f32 = torch.float32
    gx = _grid(wo, img.device)
    gy = _grid(ho, img.device)
    wx, wy = zf.wx.to(f32), zf.wy.to(f32)
    tx, ty = zf.tx.to(f32), zf.ty.to(f32)
    sx = (_fma32(wx[:, None], gx[None, :], tx[:, None]) + 1.0) * ((w - 1) * 0.5)
    sy = (_fma32(wy[:, None], gy[None, :], ty[:, None]) + 1.0) * ((h - 1) * 0.5)
    wmat_x = _interp_weights(sx, w).to(img.dtype).to(f32)  # (B, Wo, W)
    wmat_y = _interp_weights(sy, h).to(img.dtype).to(f32)  # (B, Ho, H)
    tmp = torch.einsum("bih,bchw->bciw", wmat_y, img.to(f32))
    out = torch.einsum("bciw,bjw->bcij", tmp, wmat_x)
    return out.to(img.dtype)
