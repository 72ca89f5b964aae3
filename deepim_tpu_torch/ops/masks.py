"""Mask-strategy ops (PyTorch counterpart of deepim_tpu/ops/masks.py):
filled-box masks and the random directional dilation augmentation (the
reference's lib/utils/mask_dilate.py:10-47, batched)."""
from __future__ import annotations

import torch

from deepim_tpu_torch.ops.zoom import mask_bbox


def box_fill(mask: torch.Tensor) -> torch.Tensor:
    """Filled bounding-box rectangle of each (B, H, W) or (B, 1, H, W) mask,
    [start, end) semantics (`mask[y0:y1, x0:x1] = 1`); empty masks give
    empty boxes."""
    squeeze = mask.dim() == 4
    m = mask[:, 0] if squeeze else mask
    b, h, w = m.shape
    x0, x1, y0, y1, valid = mask_bbox(m)
    ys = torch.arange(h, dtype=torch.float32, device=m.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=m.device)[None, None, :]
    box = (
        (ys >= y0[:, None, None]) & (ys < y1[:, None, None])
        & (xs >= x0[:, None, None]) & (xs < x1[:, None, None])
        & valid[:, None, None]
    ).to(mask.dtype)
    return box[:, None] if squeeze else box


# (dy, dx) of the four expansion directions, and the direction codes that
# disable each: down unless the code is 0, 1 or 4; up unless 1, 2 or 5;
# right unless 2, 3 or 6; left unless 0, 3 or 7 (codes 8 and 9 expand all four).
_DIRECTIONS = (((1, 0), (0, 1, 4)), ((-1, 0), (1, 2, 5)), ((0, 1), (2, 3, 6)), ((0, -1), (0, 3, 7)))


def _shift(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(B, H, W) moved by (dy, dx) pixels, zero fill."""
    h, w = m.shape[-2:]
    out = torch.zeros_like(m)
    out[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        m[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def mask_dilate(mask: torch.Tensor, direction: torch.Tensor, thickness: torch.Tensor) -> torch.Tensor:
    """Directional dilation of (B, H, W) masks in {0, 1}: sample b expands
    in each direction its code direction[b] in [0, 10) leaves enabled by
    thickness[d, b] >= 1 pixels (d: down, up, right, left), each direction
    ORing the shifts 1..t of the original mask."""
    direction = direction.to(mask.device)
    thickness = thickness.to(mask.device)
    steps = int(thickness.max()) if thickness.numel() else 0
    out = mask
    for d, ((sy, sx), blocked) in enumerate(_DIRECTIONS):
        enabled = ~((direction == blocked[0]) | (direction == blocked[1]) | (direction == blocked[2]))
        for step in range(1, steps + 1):
            use = (enabled & (thickness[d] >= step)).to(mask.dtype)[:, None, None]
            out = torch.maximum(out, _shift(mask, sy * step, sx * step) * use)
    return out


def mask_dilate_random(mask: torch.Tensor, generator: torch.Generator, max_thickness: int = 10) -> torch.Tensor:
    """mask_dilate with a direction code in [0, 10) and four thicknesses in
    [1, max_thickness] a sample, 5 B integers drawn from `generator` (a CPU
    generator, so the card and the CPU dilate alike from one seed)."""
    b = mask.shape[0]
    direction = torch.randint(0, 10, (b,), generator=generator)
    thickness = torch.randint(1, max_thickness + 1, (4, b), generator=generator)
    return mask_dilate(mask, direction, thickness)
