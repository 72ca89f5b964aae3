"""Canny edge detection in numpy and scipy, so the port's edge overlays
need no image package.

canny(img, low, high) computes what cv2.Canny(img, low, high) computes for
a single-channel uint8 image with the defaults the overlays use (a 3x3
Sobel aperture, L1 gradient magnitude):

- Sobel derivatives over replicated borders, in integers;
- magnitude |dx| + |dy|, compared with floor(low) and floor(high);
- non-maximum suppression in four directions, picked by the fixed-point
  test of cv2 (tan 22.5 deg as 13573 / 2**15), with its asymmetric
  comparisons: strictly greater than the left / upper neighbour, at least
  the right / lower one, strictly greater than both diagonal ones; outside
  the image the magnitude is 0;
- hysteresis: a surviving pixel above `low` is an edge when its
  8-connected component of surviving pixels holds one above `high`.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def _sobel(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """3x3 Sobel derivatives (dx, dy) of a 2-D image over replicated
    borders, as int32."""
    p = np.pad(np.asarray(img).astype(np.int32), 1, mode="edge")
    dx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    dy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    return dx, dy


def canny(img_u8: np.ndarray, low: float, high: float) -> np.ndarray:
    """Edges of a (H, W) uint8 image: a (H, W) uint8 map of 0 and 255."""
    img = np.asarray(img_u8)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"canny takes a 2-D uint8 image, got {img.dtype} {img.shape}")
    if low > high:
        low, high = high, low
    lo, hi = math.floor(low), math.floor(high)
    dx, dy = _sobel(img)
    mag = np.abs(dx) + np.abs(dy)
    m = np.pad(mag, 1)  # zero magnitude outside the image

    def at(oy: int, ox: int) -> np.ndarray:
        return m[1 + oy:m.shape[0] - 1 + oy, 1 + ox:m.shape[1] - 1 + ox]

    x = np.abs(dx).astype(np.int64)
    y = np.abs(dy).astype(np.int64) << _CANNY_SHIFT
    tg22x = x * _TG22
    tg67x = tg22x + (x << (_CANNY_SHIFT + 1))
    horizontal = y < tg22x
    vertical = ~horizontal & (y > tg67x)
    diagonal = ~horizontal & ~vertical
    # Gradient signs alike: the upper-left and lower-right neighbours; else
    # the upper-right and lower-left ones.
    same_sign = (dx ^ dy) >= 0
    peak = (
        (horizontal & (mag > at(0, -1)) & (mag >= at(0, 1)))
        | (vertical & (mag > at(-1, 0)) & (mag >= at(1, 0)))
        | (diagonal & same_sign & (mag > at(-1, -1)) & (mag > at(1, 1)))
        | (diagonal & ~same_sign & (mag > at(-1, 1)) & (mag > at(1, -1)))
    )
    candidate = peak & (mag > lo)
    labels, n = ndimage.label(candidate, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros(img.shape, np.uint8)
    strong = np.zeros(n + 1, bool)
    strong[labels[candidate & (mag > hi)]] = True
    strong[0] = False
    return np.where(strong[labels], 255, 0).astype(np.uint8)
