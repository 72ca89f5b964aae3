"""Devkit adaptation: BOP-format LINEMOD -> the LM6d_refine layout
(counterpart of deepim_tpu/toolkit/adapt_devkit.py).

Re-implements toolkit/LM6d_devkit/:

* `rescale-models` (LM6d_0_rescale_models.py): read each class's BOP ply
  (millimeters), scale to meters, write models/<cls>/points.xyz and a
  vertex-colored textured.obj (the reference delegates obj/texture export to
  meshlab; render/mesh.py loads either), plus models_info.txt with the
  diameters.
* `calc-extents` (LM6d_1_calc_extents.py): per-class extent = 2 * max |xyz|
  over points.xyz -> models/extents.txt.
* `adapt-images` (LM6d_2a_adapt_images.py): copy BOP scene rgb/depth into
  data/observed/<obj_id:02d>/<im_id+1:06d>-color/-depth.png, build the
  depth-sorted multi-instance label image from the BOP masks, write a
  -meta.mat (cls_indexes/boxes/poses, mm->m translation) per frame, and the
  per-class observed index lists.

Masks are read as cv2.imread(IMREAD_UNCHANGED) reads them (utils/imread.py)
and labels written with utils/png.py (8-bit gray PNGs).

    python -m deepim_tpu_torch.toolkit.adapt_devkit rescale-models --origin-models <bop>/models
        --out-models <devkit>/models [--classes C ...] [--device cuda|cpu]
    python -m deepim_tpu_torch.toolkit.adapt_devkit calc-extents --models-dir <devkit>/models [--classes C ...]
        [--device cuda|cpu]
    python -m deepim_tpu_torch.toolkit.adapt_devkit adapt-images --origin-root <bop>/test --out-root <devkit>
        [--classes C ...] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from shutil import copyfile

import numpy as np

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.render.mesh import load_ply, write_obj
from deepim_tpu_torch.toolkit._common import Devkit, resolve_classes, write_label_png
from deepim_tpu_torch.utils.imread import imread


def rescale_models(origin_models: str, out_models: str, classes: list[str] | None = None,
                   scale: float = 1.0 / 1000.0) -> None:
    os.makedirs(out_models, exist_ok=True)
    info_lines = []
    for cls_idx, cls_name in resolve_classes(classes).items():
        ply = osp.join(origin_models, f"obj_{cls_idx:06d}.ply")
        if not osp.exists(ply):
            ply = osp.join(origin_models, f"obj_{cls_idx:02d}.ply")
        mesh = load_ply(ply, scale=scale)
        mdir = osp.join(out_models, cls_name)
        os.makedirs(mdir, exist_ok=True)
        np.savetxt(osp.join(mdir, "points.xyz"), mesh.vertices, fmt="%.6f")
        write_obj(osp.join(mdir, "textured.obj"), mesh)
        info_lines.append(f"{cls_idx} d {mesh.diameter() * 1000.0:.4f}")
        print(f"{cls_name}: {mesh.num_vertices} verts, diameter {mesh.diameter()*100:.2f} cm")
    with open(osp.join(out_models, "models_info.txt"), "w") as f:
        f.write("\n".join(info_lines) + "\n")


def calc_extents(models_dir: str, classes: list[str] | None = None) -> np.ndarray:
    """models/extents.txt: per class 2 * max|xyz| (LM6d_1_calc_extents.py),
    one row a class in the order of the sorted class names."""
    cls_map = resolve_classes(classes)
    names = sorted(cls_map.values())
    extents = np.zeros((len(names), 3))
    for i, cls_name in enumerate(names):
        pts = np.loadtxt(osp.join(models_dir, cls_name, "points.xyz"))
        extents[i] = 2 * np.max(np.abs(pts[:, :3]), axis=0)
    np.savetxt(osp.join(models_dir, "extents.txt"), extents, fmt="%.6f", delimiter=" ")
    return extents


def adapt_images(origin_root: str, out_root: str, classes: list[str] | None = None) -> None:
    import scipy.io as sio

    dk = Devkit(out_root)
    os.makedirs(dk.observed_set_dir, exist_ok=True)
    for cls_idx, cls_name in resolve_classes(classes).items():
        scene = osp.join(origin_root, f"{cls_idx:06d}")
        with open(osp.join(scene, "scene_gt.json")) as f:
            gt_dict = json.load(f)
        info_path = osp.join(scene, "scene_gt_info.json")
        gt_info = {}
        if osp.exists(info_path):
            with open(info_path) as f:
                gt_info = json.load(f)

        observed_indices = []
        out_dir = osp.join(dk.observed_dir, f"{cls_idx:02d}")
        os.makedirs(out_dir, exist_ok=True)
        for str_im_id in sorted(gt_dict, key=int):
            int_im_id = int(str_im_id)
            new_img_id = int_im_id + 1
            copyfile(
                osp.join(scene, f"rgb/{int_im_id:06d}.png"),
                osp.join(out_dir, f"{new_img_id:06d}-color.png"),
            )
            copyfile(
                osp.join(scene, f"depth/{int_im_id:06d}.png"),
                osp.join(out_dir, f"{new_img_id:06d}-depth.png"),
            )
            instances = gt_dict[str_im_id]
            n = len(instances)
            meta = {
                "cls_indexes": np.zeros((1, n), np.int32),
                "boxes": np.zeros((n, 4), np.float32),
                "poses": np.zeros((3, 4, n), np.float32),
            }
            label_by_cls, distances = {}, []
            for ins_id, inst in enumerate(instances):
                obj = int(inst["obj_id"])
                meta["cls_indexes"][0, ins_id] = obj
                if gt_info:
                    meta["boxes"][ins_id] = np.asarray(gt_info[str_im_id][ins_id]["bbox_visib"])
                pose = np.zeros((3, 4), np.float32)
                pose[:, :3] = np.asarray(inst["cam_R_m2c"]).reshape(3, 3)
                pose[:, 3] = np.asarray(inst["cam_t_m2c"]) / 1000.0
                meta["poses"][:, :, ins_id] = pose
                distances.append(pose[2, 3])
                mask = imread(osp.join(scene, f"mask/{int_im_id:06d}_{ins_id:06d}.png"), "unchanged")
                label_by_cls[obj] = (mask > 0).astype(np.uint8)
            sio.savemat(osp.join(out_dir, f"{new_img_id:06d}-meta.mat"), meta)

            # Deeper instances first so closer objects overwrite (2a:150-156).
            h, w = next(iter(label_by_cls.values())).shape
            res_label = np.zeros((h, w), np.uint8)
            for dis_id in sorted(range(n), key=lambda i: -distances[i]):
                obj = int(meta["cls_indexes"][0, dis_id])
                res_label[label_by_cls[obj] == 1] = obj
            write_label_png(osp.join(out_dir, f"{new_img_id:06d}-label.png"), res_label)
            observed_indices.append(f"{cls_idx:02d}/{new_img_id:06d}")

        with open(osp.join(dk.observed_set_dir, f"{cls_name}_all.txt"), "w") as f:
            f.write("\n".join(observed_indices) + "\n")
        print(f"{cls_name}: adapted {len(observed_indices)} frames")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("rescale-models")
    p.add_argument("--origin-models", required=True)
    p.add_argument("--out-models", required=True)
    p.add_argument("--classes", nargs="*", default=None)
    p = sub.add_parser("calc-extents")
    p.add_argument("--models-dir", required=True)
    p.add_argument("--classes", nargs="*", default=None)
    p = sub.add_parser("adapt-images")
    p.add_argument("--origin-root", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--classes", nargs="*", default=None)
    for p in sub.choices.values():
        p.add_argument("--device", default="cuda", help="checked like every toolkit stage's; these run on the host")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.cmd == "rescale-models":
        rescale_models(args.origin_models, args.out_models, args.classes)
    elif args.cmd == "calc-extents":
        calc_extents(args.models_dir, args.classes)
    elif args.cmd == "adapt-images":
        adapt_images(args.origin_root, args.out_root, args.classes)


if __name__ == "__main__":
    main()
