"""Optical-flow colouring with the Sintel colour wheel, in numpy (copy of
deepim_tpu/utils/flow_vis.py; the reference's lib/utils/show_flows.py)."""
from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """flow: (H, W, 2) in (dw, dh) -> (H, W, 3) uint8 RGB.  The hue is the
    direction, the saturation the magnitude over `max_flow` (default the
    largest magnitude in the frame); beyond it the colour darkens."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    max_rad = max_flow or max(np.max(rad), 1e-6)
    u, v = u / max_rad, v / max_rad
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col).astype(np.uint8)
    return img
