"""Single-object renderer with pysixd's API (counterpart of
deepim_tpu/render/standalone.py; the reference's lib/utils/renderer.py):
render a model at (K, R, t) to an RGB and/or depth image with flat or
headlight Phong shading, optionally sampling a texture per fragment.  A
convenience for data preparation and visualisation, through the same
rasterizer and kernels as the refinement.
"""
from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.render.lighting import compute_vertex_normals
from deepim_tpu_torch.render.rasterizer import RasterConfig, rasterize_single, rasterize_textured, uses_csr


def raster_config(model, im_size: tuple[int, int], k: np.ndarray, pose: np.ndarray, clip_near: float,
                  clip_far: float) -> RasterConfig:
    """The RasterConfig `render` uses for `model` at `pose` (3, 4): tiles
    of 8 (else 16) rows and 128 (else 16) columns, whichever divides the
    image; every tile rasterized (active_tiles 0: one image has no batch
    to budget for, and the JAX renderer's default of 128 dense tiles
    leaves holes in an object covering more); and, for a mesh above 2,048
    faces (the CSR kernel), the pair budget under which no face at this
    pose drops a tile (tune_raster_for_bank from the nearest vertex's
    depth)."""
    from deepim_tpu_torch.engine.refine import EngineConfig, tune_raster_for_bank

    w, h = im_size
    cfg = RasterConfig(height=h, width=w, tile_h=8 if h % 8 == 0 else 16, tile_w=128 if w % 128 == 0 else 16,
                       znear=clip_near, zfar=clip_far, active_tiles=0)
    if not uses_csr(cfg, model.num_faces):
        return cfg
    z_near = float((model.vertices @ pose[:, :3].T + pose[:, 3])[:, 2].min())
    bank = (model.vertices[None], None, model.faces[None], np.ones((1, model.num_faces), bool))
    return tune_raster_for_bank(EngineConfig(height=h, width=w, raster=cfg), bank, k, z_min=z_near).raster


def render(model, im_size: tuple[int, int], k: np.ndarray, r: np.ndarray, t: np.ndarray,
           clip_near: float = 0.1, clip_far: float = 10.0,
           surf_color: tuple[float, float, float] | None = None, mode: str = "rgb+depth",
           shading: str = "flat", ambient_weight: float = 0.5, texture: np.ndarray | None = None,
           bg_color: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0), device="cuda"):
    """Render one model (render.mesh.Mesh: load_ply or load_textured_mesh)
    at one pose; numpy in, numpy out.

    im_size: (width, height) as in pysixd; k: (3, 3); r: (3, 3); t: (3,)
    metres.  mode: 'rgb', 'depth' or 'rgb+depth'; shading: 'flat' or
    'phong' (a Lambert term against the view direction plus
    `ambient_weight`, per vertex: the reference's light at the camera).
    texture: (TH, TW, 3) uint8 or [0, 1] float image sampled per fragment
    through the model's uv (v up); with 'phong' the per-vertex light
    weights are rendered too and multiply the sampled colour.  bg_color:
    RGB(A) in [0, 1] for the pixels nothing covers (alpha ignored).
    Returns rgb (H, W, 3) uint8, depth (H, W) float32 metres, or both.
    The rasterizer's settings are raster_config's."""
    dev = resolve_device(device)
    w, h = im_size
    r = np.asarray(r, np.float32)
    t = np.asarray(t, np.float32).reshape(3)
    k = np.asarray(k, np.float32)
    pose = np.concatenate([r, t.reshape(3, 1)], axis=1)
    colors = model.colors
    if surf_color is not None:
        colors = np.tile(np.asarray(surf_color, np.float32) * 255.0, (model.num_vertices, 1))
    if shading == "phong":
        normals = model.normals if model.normals is not None else compute_vertex_normals(model.vertices,
                                                                                         model.faces)
        n_cam = normals @ r.T
        v_cam = model.vertices @ r.T + t
        view = -v_cam / np.maximum(np.linalg.norm(v_cam, axis=1, keepdims=True), 1e-9)
        lam = np.clip(np.sum(n_cam * view, axis=1), 0.0, 1.0)[:, None]
        colors = colors * (ambient_weight + (1.0 - ambient_weight) * lam)
    elif shading != "flat":
        raise ValueError(f"unknown shading {shading!r}")

    cfg = raster_config(model, (w, h), k, pose, clip_near, clip_far)

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    verts, faces = tensor(model.vertices), torch.from_numpy(np.asarray(model.faces, np.int32)).to(dev)
    valid = torch.ones(model.num_faces, dtype=torch.bool, device=dev)
    pose_t, k_t = tensor(pose), tensor(k)
    if texture is not None:
        if model.uv is None:
            raise ValueError("texture given but the model has no uv coordinates")
        tex = np.asarray(texture, np.float32)
        if tex.max() <= 1.0 + 1e-6:
            tex = tex * 255.0
        rgb, depth = rasterize_textured(verts[None], tensor(model.uv)[None], tensor(tex)[None], faces[None],
                                        valid[None], pose_t[None], k_t, cfg, device=dev)
        rgb, depth = rgb[0], depth[0]
        if shading == "phong":
            lw, _ = rasterize_single(verts, tensor(np.broadcast_to(lam * 255.0, (model.num_vertices, 3))),
                                     faces, valid, pose_t, k_t, cfg, device=dev)
            rgb = rgb * (ambient_weight + (1.0 - ambient_weight) * lw / 255.0)
    else:
        rgb, depth = rasterize_single(verts, tensor(colors), faces, valid, pose_t, k_t, cfg, device=dev)
    depth = depth.cpu().numpy()
    rgb = rgb.cpu().numpy()
    if any(c != 0.0 for c in bg_color[:3]):
        bg = np.asarray(bg_color[:3], np.float32) * 255.0
        rgb = np.where((depth > 0)[..., None], rgb, bg)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if mode == "rgb":
        return rgb
    if mode == "depth":
        return depth
    return rgb, depth
