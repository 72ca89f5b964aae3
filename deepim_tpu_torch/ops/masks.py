"""Mask-strategy ops (PyTorch counterpart of deepim_tpu/ops/masks.py)."""
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
