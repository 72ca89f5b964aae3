"""Training-batch visualizers for TRAIN.VISUALIZE (counterpart of
deepim_tpu/utils/visualize.py; the reference's SimpleVisualize,
MaskVisualize and MinibatchVisualize metrics, deepim/core/metric.py:140-486,
as PNG grids).  Grids are written
in RGB through utils/png.py."""
from __future__ import annotations

import os

import numpy as np

from deepim_tpu_torch.utils.flow_vis import flow_to_color
from deepim_tpu_torch.utils.png import write_png


def _to_u8_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3):  # CHW -> HWC
        img = img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
        if img.max() <= 1.0:
            img = img * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _row(panels: list[np.ndarray]) -> np.ndarray:
    h = max(p.shape[0] for p in panels)
    w = max(p.shape[1] for p in panels)
    padded = []
    for p in panels:
        canvas = np.zeros((h, w, 3), np.uint8)
        canvas[: p.shape[0], : p.shape[1]] = p
        padded.append(canvas)
    return np.concatenate(padded, axis=1)


def save_grid(path: str, rows: list[list[np.ndarray]]) -> None:
    """Panels (CHW or HWC, RGB [0, 255] or masks in [0, 1]) as one RGB PNG,
    a row of panels per list."""
    grid = np.concatenate([_row([_to_u8_hwc(p) for p in r]) for r in rows], axis=0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, grid)


def visualize_pair_grid(out_path: str, image_observed: np.ndarray, image_rendered: np.ndarray,
                        max_samples: int = 4) -> None:
    """Per sample: observed | rendered | |difference|."""
    rows = []
    for j in range(min(len(image_observed), max_samples)):
        obs = _to_u8_hwc(image_observed[j])
        rend = _to_u8_hwc(image_rendered[j])
        diff = np.abs(obs.astype(np.int64) - rend.astype(np.int64)).astype(np.uint8)
        rows.append([obs, rend, diff])
    save_grid(out_path, rows)


def visualize_masks(out_path: str, mask_observed: np.ndarray, mask_rendered: np.ndarray,
                    mask_gt: np.ndarray | None = None, max_samples: int = 4) -> None:
    """Per sample: the masks side by side."""
    rows = []
    for j in range(min(len(mask_observed), max_samples)):
        row = [mask_observed[j], mask_rendered[j]]
        if mask_gt is not None:
            row.append(mask_gt[j])
        rows.append(row)
    save_grid(out_path, rows)


def visualize_minibatch(out_path: str, batch_images: dict[str, np.ndarray], flow: np.ndarray | None = None,
                        max_samples: int = 2) -> None:
    """Per sample: each of batch_images' (B, C, H, W) or (B, H, W, C) panels,
    then the flow ((B, 2, H, W) or (B, H, W, 2), in (dw, dh)) in the Sintel
    colour wheel."""
    rows = []
    n = min(next(iter(batch_images.values())).shape[0], max_samples)
    for j in range(n):
        row = [v[j] for v in batch_images.values()]
        if flow is not None:
            f = np.asarray(flow[j])
            if f.shape[0] == 2:
                f = f.transpose(1, 2, 0)
            row.append(flow_to_color(f))
        rows.append(row)
    save_grid(out_path, rows)
