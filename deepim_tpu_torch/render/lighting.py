"""Point-light shading for the unseen-object (ModelNet) render path
(PyTorch counterpart of deepim_tpu/render/lighting.py).

The reference's light shader (lib/render_glumpy/render_py_light.py:13-80)
computed per vertex:

    brightness = clamp(dot(normalize(R n), normalize(light_pos - p_cam)), 0, 1)
    color      = base_color * ((1 - k) + k * brightness * light_intensity)

with k the brightness ratio.  The rasterizer interpolates vertex colours
perspective-correctly, so lighting the vertices stands in for the
reference's interpolated-normal fragment shading on dense meshes.
"""
from __future__ import annotations

import numpy as np
import torch


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals, (V, 3) float32 (host side, at
    mesh load; summed in float64)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])  # area-weighted
    n = np.zeros_like(v)
    for i in range(3):
        np.add.at(n, f[:, i], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)


def _rotate(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) x (B, V, 3) -> (B, V, 3) as explicit elementwise sums, so
    the float32 rounding does not depend on a matmul backend (TF32)."""
    return torch.stack([
        r[:, i, 0:1] * x[..., 0] + r[:, i, 1:2] * x[..., 1] + r[:, i, 2:3] * x[..., 2]
        for i in range(3)
    ], dim=-1)


def lit_vertex_colors(vertices, normals, base_colors, pose, light_position, light_intensity,
                      brightness_ratio=0.4) -> torch.Tensor:
    """Vertex colours under the point-light model.

    vertices, normals: (B, V, 3) model frame; base_colors: (B, V, 3) in
    [0, 255]; pose: (B, 3, 4); light_position (camera frame) and
    light_intensity: (3,) or (B, 3); brightness_ratio: a scalar or (B,).
    Returns (B, V, 3) clipped to [0, 255], on the vertices' device."""
    b = vertices.shape[0]
    r, t = pose[:, :, :3], pose[:, :, 3]
    p_cam = _rotate(r, vertices) + t[:, None, :]
    n_cam = _rotate(r, normals)
    lp = torch.as_tensor(light_position, dtype=p_cam.dtype, device=p_cam.device).expand(b, 3)
    to_light = lp[:, None, :] - p_cam
    cos = (n_cam * to_light).sum(-1) / (
        torch.linalg.vector_norm(to_light, dim=-1)
        * torch.clamp(torch.linalg.vector_norm(n_cam, dim=-1), min=1e-12)
    )
    brightness = torch.clamp(cos, 0.0, 1.0)
    li = torch.as_tensor(light_intensity, dtype=p_cam.dtype, device=p_cam.device).expand(b, 3)
    k = torch.as_tensor(brightness_ratio, dtype=p_cam.dtype, device=p_cam.device)
    if k.dim() == 1:  # per-sample ratio
        k = k[:, None, None]
    scale = (1.0 - k) + k * brightness[..., None] * li[:, None, :]
    return torch.clamp(base_colors * scale, 0.0, 255.0)
