"""Plain z-buffer renderer of coloured triangle meshes.

Conventions (those of the renders DeepIM compares against): pixel (i, j)
is the image-plane point u = fx x / z + cx = j, v = fy y / z + cy = i;
a face with a corner outside (znear, zfar) or a screen area of at most
1e-6 pixels is not drawn; a pixel is covered where all three edge
functions, anchored at the face's first corner, are >= 0; the face with
the largest interpolated 1/z (clamped to its corners' range) wins, an
exact tie going to the lowest face id; colours are interpolated
perspective-correctly (colour * 1/z interpolated in screen space, divided
by the pixel's 1/z); depth is camera z, 0 where nothing is drawn.

Each face enumerates the integer pixels of its screen bounding box and
keeps the covered ones; a scatter-max over (1/z bits, inverted face id)
keys resolves visibility.  No tiling, no budget: nothing is dropped.
"""
from __future__ import annotations

import torch

_MAX_ID = (1 << 31) - 1


def project(vertices: torch.Tensor, pose: torch.Tensor, k: torch.Tensor):
    """(B, N, 3) model points, (B, 3, 4) poses, (3, 3) K -> u, v, z (B, N)."""
    x, y, z = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    r, t = pose[:, :, :3], pose[:, :, 3]
    cam = [r[:, i, 0:1] * x + r[:, i, 1:2] * y + r[:, i, 2:3] * z + t[:, i:i + 1] for i in range(3)]
    zc = cam[2]
    zs = torch.where(torch.abs(zc) < 1e-12, torch.full_like(zc, 1e-12), zc)
    u = (k[0, 0] * cam[0] + k[0, 1] * cam[1]) / zs + k[0, 2]
    v = k[1, 1] * cam[1] / zs + k[1, 2]
    return u, v, zc


def _planes(fu, fv, fq, fcol):
    """Per face: edge planes, the 1/z plane and the colour * 1/z planes,
    each as (a, b, c) with value a dx + b dy + c at dx = px - u0,
    dy = py - v0.  fu, fv, fq: (F, 3); fcol: (F, 3, 3)."""
    u0, u1, u2 = fu[:, 0], fu[:, 1], fu[:, 2]
    v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
    area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0)
    s = torch.sign(area)
    inv = 1.0 / torch.where(area == 0, torch.ones_like(area), area)

    def attr(val):
        d1 = val[:, 1] - val[:, 0]
        d2 = val[:, 2] - val[:, 0]
        return ((d1 * (v2 - v0) - d2 * (v1 - v0)) * inv, (d2 * (u1 - u0) - d1 * (u2 - u0)) * inv, val[:, 0])

    edges = ((-(v2 - v1) * s, (u2 - u1) * s, torch.abs(area)),
             (-(v0 - v2) * s, (u0 - u2) * s, None),
             (-(v1 - v0) * s, (u1 - u0) * s, None))
    return area, edges, attr(fq), [attr(fcol[:, :, c] * fq) for c in range(3)]


def render(vertices, colors, faces, face_valid, pose, k, height: int, width: int,
           znear: float, zfar: float, stats: dict | None = None):
    """Render a batch: vertices/colors (B, V, 3), faces (B, F, 3) int,
    face_valid (B, F) bool, pose (B, 3, 4), k (3, 3).  Returns rgb
    (B, 3, H, W) in [0, 255] and depth (B, 1, H, W).  With `stats`, adds
    its 'covered_pairs' (face-pixel pairs that test inside), 'faces_in_view'
    (drawable faces whose box meets the frame) and 'pixels_covered'."""
    b = faces.shape[0]
    dev = vertices.device
    rgb = torch.zeros((b, 3, height * width), dtype=torch.float32, device=dev)
    depth = torch.zeros((b, height * width), dtype=torch.float32, device=dev)
    u, v, z = project(vertices, pose, k)
    for i in range(b):
        f = faces[i].long()
        fu, fv, fz = u[i][f], v[i][f], z[i][f]
        area_s = (fu[:, 1] - fu[:, 0]) * (fv[:, 2] - fv[:, 0]) - (fv[:, 1] - fv[:, 0]) * (fu[:, 2] - fu[:, 0])
        ok = face_valid[i] & ((fz > znear) & (fz < zfar)).all(-1) & (torch.abs(area_s) > 1e-6)
        x0 = torch.clamp(torch.ceil(fu.amin(-1)), min=0)
        x1 = torch.clamp(torch.floor(fu.amax(-1)), max=width - 1)
        y0 = torch.clamp(torch.ceil(fv.amin(-1)), min=0)
        y1 = torch.clamp(torch.floor(fv.amax(-1)), max=height - 1)
        nx = torch.clamp(x1 - x0 + 1, min=0).long()
        ny = torch.clamp(y1 - y0 + 1, min=0).long()
        n = torch.where(ok, nx * ny, 0)
        if stats is not None:
            onscreen = ok & (fu.amax(-1) >= 0) & (fu.amin(-1) <= width - 1) & \
                (fv.amax(-1) >= 0) & (fv.amin(-1) <= height - 1)
            stats["faces_in_view"] = stats.get("faces_in_view", 0) + int(onscreen.sum())
        sel = torch.nonzero(n > 0)[:, 0]
        if sel.numel() == 0:
            continue
        fq = 1.0 / fz[sel]
        area, edges, qp, cps = _planes(fu[sel], fv[sel], fq, colors[i][f[sel]])
        cnt = n[sel]
        rep = torch.repeat_interleave(torch.arange(sel.numel(), device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(rep.numel(), device=dev) - start[rep]
        px = x0[sel][rep] + (local % nx[sel][rep]).float()
        py = y0[sel][rep] + torch.div(local, nx[sel][rep], rounding_mode="floor").float()
        dx = px - fu[sel, 0][rep]
        dy = py - fv[sel, 0][rep]
        inside = (area[rep] != 0)
        for a, bb, c in edges:
            e = a[rep] * dx + bb[rep] * dy
            if c is not None:
                e = e + c[rep]
            inside = inside & (e >= 0)
        rep, dx, dy = rep[inside], dx[inside], dy[inside]
        pix = (py[inside] * width + px[inside]).long()
        qi = qp[0][rep] * dx + qp[1][rep] * dy + qp[2][rep]
        qi = torch.minimum(torch.maximum(qi, fq.amin(-1)[rep]), fq.amax(-1)[rep])
        fid = sel[rep]
        key = (qi.view(torch.int32).long() << 31) | (_MAX_ID - fid)
        zbuf = torch.full((height * width,), -1, dtype=torch.long, device=dev)
        zbuf.scatter_reduce_(0, pix, key, "amax")
        won = zbuf[pix] == key
        pix, rep, dx, dy, qi = pix[won], rep[won], dx[won], dy[won], qi[won]
        depth[i, pix] = 1.0 / qi
        for c in range(3):
            a, bb, cc = cps[c]
            rgb[i, c, pix] = (a[rep] * dx + bb[rep] * dy + cc[rep]) / qi
        if stats is not None:
            stats["covered_pairs"] = stats.get("covered_pairs", 0) + int(inside.sum())
            stats["pixels_covered"] = stats.get("pixels_covered", 0) + int(pix.numel())
    return rgb.reshape(b, 3, height, width), depth.reshape(b, 1, height, width)
