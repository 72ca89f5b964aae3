"""Generate an LM6d_refine-layout dataset from meshes (the generators of
deepim_tpu/tools/synth_data.py, rendering with the port's rasterizer and
writing PNGs with utils/png.py).  The single-object layout:

    data/observed/<class>/<idx>-color.png / -depth.png / -label.png
    data/gt_observed/<class>/<idx>-color.png / -depth.png / -pose.txt
    data/rendered/<class>/<idx>_<k>-color.png / -depth.png / -pose.txt
    image_set/train_<class>.txt, val_<class>.txt
    models/<class>/points.xyz, textured.obj; models/models_info.txt

The same seed draws the same poses as the JAX generator, and the JAX
package's PairDB reads the result unchanged.  Initial poses perturb the gt
pose with per-axis Euler noise N(0, 15 deg) clipped at 45 deg and
translation noise N(0, (0.01, 0.01, 0.05)) m, or draw from a weighted
mix of such models (generate_dataset's noise_mix).  Every PNG row is Sub
filtered, as cv2.imwrite (the JAX generator's writer) filters them, so the
files decode as the JAX-written devkit's do.  generate_occlusion_dataset
writes multi-instance scenes instead (--occlusion; its docstring has the
layout).

    python -m deepim_tpu_torch.tools.synth_data --out <dir> [--n-train 64] [--n-val 16]
        [--per-observed 1] [--occlusion] [--device cuda|cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from deepim_tpu_torch.data.pairdb import save_pose_file
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.engine.scene import LINEMOD_K
from deepim_tpu_torch.render.mesh import write_obj
from deepim_tpu_torch.render.rasterizer import RasterConfig, rasterize_single
from deepim_tpu_torch.utils.png import write_png

ROT_NOISE_STD_DEG = 15.0
ROT_NOISE_MAX_DEG = 45.0
TRANS_NOISE_STD = (0.01, 0.01, 0.05)
PNG_FILTER = 1  # Sub


def sample_perturbed_pose(pose: np.ndarray, rng: np.random.RandomState, rot_std_deg: float = ROT_NOISE_STD_DEG,
                          rot_max_deg: float = ROT_NOISE_MAX_DEG, trans_std: tuple = TRANS_NOISE_STD) -> np.ndarray:
    """The gt pose perturbed by per-axis Euler noise N(0, rot_std_deg)
    clipped at rot_max_deg and translation noise N(0, trans_std) m (the
    defaults: the initial-pose noise model; smaller ones make the
    near-convergence pairs of a tracking fine-tune)."""
    ang = np.clip(rng.normal(0, rot_std_deg, 3), -rot_max_deg, rot_max_deg)
    r_noise = R.from_euler("xyz", ang, degrees=True).as_matrix()
    t_noise = rng.normal(0, trans_std, 3)
    out = pose.copy().astype(np.float32)
    out[:, :3] = r_noise @ pose[:, :3]
    out[:, 3] = pose[:, 3] + t_noise
    return out


# LINEMOD's 13 objects (ape, benchvise, camera, can, cat, driller, duck,
# eggbox, glue, holepuncher, iron, lamp, phone): diameters in mm, as the
# dataset's models_info.txt gives them.
LINEMOD_DIAMETERS_MM = (102.099, 247.506, 172.492, 201.404, 154.546, 261.472, 108.999, 164.628, 175.889,
                        145.543, 278.078, 282.601, 212.358)


def linemod_standin_bank(kind: str) -> dict:
    """Stand-ins for LINEMOD's models (not in the repository) at their
    diameters, as MeshBank arrays padded to 256 faces: "ape" the ape as a
    20,480-face icosphere; "all" the 13 objects as heavy-tailed mixed-detail
    meshes (make_mixed_detail_mesh seeded by the class index, fine shells of
    subdivision 5 and 4 in turn: 20,880 or 5,520 faces), each scaled so its
    largest vertex distance is the diameter."""
    from scipy.spatial import ConvexHull
    from scipy.spatial.distance import pdist

    from deepim_tpu_torch.render.mesh import MeshBank, make_icosphere, make_mixed_detail_mesh

    if kind == "ape":
        meshes = [make_icosphere(LINEMOD_DIAMETERS_MM[0] / 2000.0, 5)]
    elif kind == "all":
        meshes = []
        for i, d_mm in enumerate(LINEMOD_DIAMETERS_MM):
            m = make_mixed_detail_mesh(i, fine_subdiv=5 - i % 2)
            span = pdist(m.vertices[ConvexHull(m.vertices).vertices]).max()
            m.vertices = (m.vertices * (d_mm / 1000.0 / span)).astype(np.float32)
            meshes.append(m)
    else:
        raise ValueError(f"unknown stand-in bank {kind!r} (ape, all)")
    return MeshBank.from_meshes(meshes, pad_multiple=256).arrays()


def linemod_refine_poses(batch: int, n_classes: int, seed: int, z_range=(0.6, 1.1),
                         k: np.ndarray = LINEMOD_K) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A refinement batch's (class ids (B,) int64, gt poses, initial poses
    (B, 3, 4) float32): classes evenly over the batch in a shuffled order,
    one depth in each 1/B slice of z_range, the object's centre projected
    uniformly into u 200-440, v 150-330 px, uniform rotations, initial poses
    by sample_perturbed_pose."""
    rng = np.random.default_rng(seed)
    cls = np.resize(np.arange(n_classes), batch)
    rng.shuffle(cls)
    z_lo, z_hi = z_range
    z = z_lo + (rng.permutation(batch) + rng.uniform(size=batch)) / batch * (z_hi - z_lo)
    u, v = rng.uniform(200, 440, batch), rng.uniform(150, 330, batch)
    t = np.stack([(u - k[0, 2]) * z / k[0, 0], (v - k[1, 2]) * z / k[1, 1], z], -1)
    gt = np.concatenate([R.random(batch, random_state=rng).as_matrix(), t[:, :, None]], -1).astype(np.float32)
    pose0 = np.stack([sample_perturbed_pose(g, rng) for g in gt]).astype(np.float32)
    return cls.astype(np.int64), gt, pose0


def _write_models(devkit_path: str, meshes: dict) -> None:
    """models/<class>/points.xyz and textured.obj, and models_info.txt
    (id, diameter in mm) with ids 1..C in sorted class order."""
    info_lines = []
    for ci, cls in enumerate(sorted(meshes), start=1):
        mesh = meshes[cls]
        mdir = os.path.join(devkit_path, "models", cls)
        os.makedirs(mdir, exist_ok=True)
        np.savetxt(os.path.join(mdir, "points.xyz"), mesh.vertices)
        write_obj(os.path.join(mdir, "textured.obj"), mesh)
        info_lines.append(f"{ci} d {mesh.diameter() * 1000.0:.4f}")
    with open(os.path.join(devkit_path, "models", "models_info.txt"), "w") as f:
        f.write("\n".join(info_lines) + "\n")


def _renderer(mesh, k: np.ndarray, cfg: RasterConfig, dev):
    """pose (3, 4) -> numpy (rgb, depth) of `mesh` rendered alone on `dev`."""
    verts, cols = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (mesh.vertices, mesh.colors))
    faces = torch.from_numpy(np.asarray(mesh.faces, np.int32)).to(dev)
    fvalid = torch.ones(mesh.num_faces, dtype=torch.bool, device=dev)
    kt = torch.from_numpy(np.asarray(k, np.float32)).to(dev)

    def render(pose):
        rgb, depth = rasterize_single(verts, cols, faces, fvalid, torch.from_numpy(pose).to(dev), kt, cfg,
                                      device=dev)
        return rgb.cpu().numpy(), depth.cpu().numpy()

    return render


def _write_render(prefix: str, rgb: np.ndarray, depth: np.ndarray, depth_factor: float) -> None:
    """<prefix>-color.png (RGB, truncated to uint8) and -depth.png (depth x
    depth_factor, truncated to uint16)."""
    write_png(prefix + "-color.png", rgb.astype(np.uint8), PNG_FILTER)
    write_png(prefix + "-depth.png", (depth * depth_factor).astype(np.uint16), PNG_FILTER)


def generate_dataset(devkit_path: str, meshes: dict, k: np.ndarray, n_train: int = 16,
                     n_val: int = 4, rendered_per_observed: int = 1, height: int = 480,
                     width: int = 640, seed: int = 0, depth_factor: float = 1000.0,
                     z_range: tuple[float, float] = (0.5, 0.9), raster_cfg: RasterConfig | None = None,
                     noise_mix: list | None = None, device="cuda") -> None:
    """Render and write a complete LM6d_refine-layout dataset.  meshes:
    class name -> render.mesh.Mesh.

    noise_mix: None (every initial pose drawn from the initial-pose noise
    model) or a list of (weight, rot_std_deg, rot_max_deg, (tx, ty, tz)
    std) tuples: each initial pose first draws its model from the
    normalised weights (rng.choice), then its noise from that model."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    if noise_mix:
        weights = np.array([m[0] for m in noise_mix], np.float64)
        mix_p = weights / weights.sum()
    cfg = raster_cfg or RasterConfig(height=height, width=width)
    os.makedirs(devkit_path, exist_ok=True)
    classes = sorted(meshes.keys())
    _write_models(devkit_path, meshes)
    image_set_dir = os.path.join(devkit_path, "image_set")
    os.makedirs(image_set_dir, exist_ok=True)

    for ci, cls in enumerate(classes, start=1):
        render = _renderer(meshes[cls], k, cfg, dev)
        obs_dir = os.path.join(devkit_path, "data", "observed", cls)
        gt_dir = os.path.join(devkit_path, "data", "gt_observed", cls)
        rend_dir = os.path.join(devkit_path, "data", "rendered", cls)
        for d in (obs_dir, gt_dir, rend_dir):
            os.makedirs(d, exist_ok=True)

        train_lines, val_lines = [], []
        for i in range(n_train + n_val):
            idx = f"{i:06d}"
            rot = R.random(random_state=rng).as_matrix().astype(np.float32)
            t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(*z_range)],
                         np.float32)
            pose = np.concatenate([rot, t[:, None]], axis=1)
            rgb, depth = render(pose)
            _write_render(os.path.join(obs_dir, idx), rgb, depth, depth_factor)
            write_png(os.path.join(obs_dir, f"{idx}-label.png"), (depth > 0).astype(np.uint8) * ci, PNG_FILTER)
            _write_render(os.path.join(gt_dir, idx), rgb, depth, depth_factor)
            save_pose_file(os.path.join(gt_dir, f"{idx}-pose.txt"), pose)

            for kk in range(rendered_per_observed):
                ridx = f"{idx}_{kk}"
                if noise_mix:
                    _, rsd, rmd, tsd = noise_mix[rng.choice(len(noise_mix), p=mix_p)]
                    rpose = sample_perturbed_pose(pose, rng, rsd, rmd, tsd)
                else:
                    rpose = sample_perturbed_pose(pose, rng)
                _write_render(os.path.join(rend_dir, ridx), *render(rpose), depth_factor)
                save_pose_file(os.path.join(rend_dir, f"{ridx}-pose.txt"), rpose)
                line = f"{cls}/{idx} {cls}/{ridx}"
                (train_lines if i < n_train else val_lines).append(line)

        with open(os.path.join(image_set_dir, f"train_{cls}.txt"), "w") as f:
            f.write("\n".join(train_lines) + "\n")
        with open(os.path.join(image_set_dir, f"val_{cls}.txt"), "w") as f:
            f.write("\n".join(val_lines) + "\n")


def generate_occlusion_dataset(devkit_path: str, meshes: dict, k: np.ndarray, n_scenes: int = 8,
                               n_train: int = 0, height: int = 480, width: int = 640, seed: int = 0,
                               depth_factor: float = 1000.0, z_range: tuple[float, float] = (0.5, 0.9),
                               lateral_spread: float = 0.04, raster_cfg: RasterConfig | None = None,
                               device="cuda") -> None:
    """Multi-instance occlusion scenes in the LM6d_occ-style layout.  Every
    scene holds every class, jittered around a shared centre so that the
    objects occlude each other.  The observed frame is the depth composite
    of the instances rendered alone (the nearest wins a pixel, the first
    class in sorted order on a tie) and its label image holds the class id
    (1..C, sorted order, as PairDB numbers the model dirs) of each pixel:

        data/observed/scenes/<idx>-color.png / -depth.png / -label.png
        data/gt_observed/<class>/<idx>-color.png / -depth.png / -pose.txt
        data/rendered/<class>/<idx>_0-color.png / -depth.png / -pose.txt
        image_set/val_<class>.txt (the last n_scenes - n_train scenes) and,
        with n_train, train_<class>.txt (the first n_train)

    gt_observed and rendered hold each object alone at its gt and
    perturbed pose.  A scene draws every class's gt pose first, then each
    class's perturbed pose, so a seed gives the JAX generator's poses.  The
    compositing runs in numpy on the host, as the JAX generator's."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    cfg = raster_cfg or RasterConfig(height=height, width=width)
    classes = sorted(meshes.keys())
    _write_models(devkit_path, meshes)
    render = {cls: _renderer(meshes[cls], k, cfg, dev) for cls in classes}

    obs_dir = os.path.join(devkit_path, "data", "observed", "scenes")
    os.makedirs(obs_dir, exist_ok=True)
    image_set_dir = os.path.join(devkit_path, "image_set")
    os.makedirs(image_set_dir, exist_ok=True)
    lines = {cls: [] for cls in classes}

    for i in range(n_scenes):
        idx = f"{i:06d}"
        z0 = rng.uniform(*z_range)
        rgb_stack, depth_stack, poses = [], [], {}
        for cls in classes:
            rot = R.random(random_state=rng).as_matrix().astype(np.float32)
            t = np.array([rng.uniform(-lateral_spread, lateral_spread),
                          rng.uniform(-lateral_spread, lateral_spread),
                          z0 + rng.uniform(-0.05, 0.05)], np.float32)
            poses[cls] = np.concatenate([rot, t[:, None]], axis=1)
            rgb, depth = render[cls](poses[cls])
            rgb_stack.append(rgb)
            depth_stack.append(depth)

        depth_all = np.stack(depth_stack)  # (C, H, W)
        depth_inf = np.where(depth_all > 0, depth_all, np.inf)
        winner = np.argmin(depth_inf, axis=0)
        any_hit = np.isfinite(depth_inf.min(axis=0))
        scene_rgb = np.take_along_axis(np.stack(rgb_stack), winner[None, :, :, None], axis=0)[0] * any_hit[:, :, None]
        scene_depth = np.where(any_hit, np.take_along_axis(depth_all, winner[None], axis=0)[0], 0.0)
        _write_render(os.path.join(obs_dir, idx), scene_rgb, scene_depth, depth_factor)
        write_png(os.path.join(obs_dir, f"{idx}-label.png"), np.where(any_hit, winner + 1, 0).astype(np.uint8),
                  PNG_FILTER)

        for ci, cls in enumerate(classes):
            gt_dir = os.path.join(devkit_path, "data", "gt_observed", cls)
            rend_dir = os.path.join(devkit_path, "data", "rendered", cls)
            os.makedirs(gt_dir, exist_ok=True)
            os.makedirs(rend_dir, exist_ok=True)
            _write_render(os.path.join(gt_dir, idx), rgb_stack[ci], depth_stack[ci], depth_factor)
            save_pose_file(os.path.join(gt_dir, f"{idx}-pose.txt"), poses[cls])
            rpose = sample_perturbed_pose(poses[cls], rng)
            _write_render(os.path.join(rend_dir, f"{idx}_0"), *render[cls](rpose), depth_factor)
            save_pose_file(os.path.join(rend_dir, f"{idx}_0-pose.txt"), rpose)
            lines[cls].append(f"scenes/{idx} {cls}/{idx}_0")

    for cls in classes:
        with open(os.path.join(image_set_dir, f"val_{cls}.txt"), "w") as f:
            f.write("\n".join(lines[cls][n_train:]) + "\n")
        if n_train:
            with open(os.path.join(image_set_dir, f"train_{cls}.txt"), "w") as f:
                f.write("\n".join(lines[cls][:n_train]) + "\n")


def main(argv: list[str] | None = None) -> None:
    import argparse

    from deepim_tpu_torch.render.mesh import make_icosphere, make_test_cube

    ap = argparse.ArgumentParser(description="Write a synthetic LM6d_refine-layout devkit (cube + "
                                             "sphere classes, 480x640, LINEMOD intrinsics)")
    ap.add_argument("--out", required=True, help="devkit output path")
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--per-observed", type=int, default=1)
    ap.add_argument("--occlusion", action="store_true",
                    help="multi-instance occlusion scenes (LM6d_occ-style) instead of the single-object layout")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    meshes = {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 3)}
    if args.occlusion:
        generate_occlusion_dataset(args.out, meshes, LINEMOD_K, n_scenes=args.n_val + args.n_train,
                                   n_train=args.n_train, device=args.device)
    else:
        generate_dataset(args.out, meshes, LINEMOD_K, args.n_train, args.n_val, args.per_observed,
                         device=args.device)
    print("wrote dataset to", args.out)


if __name__ == "__main__":
    main()
