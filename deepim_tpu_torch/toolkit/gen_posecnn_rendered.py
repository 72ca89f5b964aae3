"""Render external-method (PoseCNN) predicted test poses (counterpart of
deepim_tpu/toolkit/gen_posecnn_rendered.py).

Re-implements toolkit/LM6d_3_gen_PoseCNN_pred_rendered.py: for every frame
of <cls>_test.txt, read the method's predicted pose (and its ICP-refined
pose), render color/depth/label at the predicted pose into
data/rendered_val_PoseCNN/<cls>/<prefix>_0-*, write -pose.txt and
-pose_icp.txt (class-index header), and emit the pair set
image_set/PoseCNN_val_<cls>.txt.  Frames with no detection are skipped from
the pair set (LM6d_3:198-199).

Prediction sources:
* the reference's layout — <pred_dir>/<cls>/%04d.mat with rois/poses/
  poses_icp (LM6d_3:109-126), or
* a plain text file <pred_dir>/<cls>_poses.txt with one "qw qx qy qz x y z"
  line per test frame (all -1 = no detection); optional <cls>_poses_icp.txt.

Pair lines use the pairdb convention "<observed_idx> <cls>/<prefix>_0"
(data/pairdb.py paths) rather than the reference's video-name-nested variant.

    python -m deepim_tpu_torch.toolkit.gen_posecnn_rendered --root <devkit> --pred-dir <dir>
        [--classes C ...] [--version PoseCNN] [--batch 8] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.toolkit._common import (
    DEFAULT_K,
    BatchRenderer,
    Devkit,
    resolve_classes,
    write_color_png,
    write_depth_png,
    write_label_png,
    write_pose_file_with_class,
)
from deepim_tpu_torch.toolkit.gen_rendered_pose import line_to_pose


def _load_predictions(pred_dir: str, cls_name: str, n_frames: int):
    """-> list of (pose (3,4) | None, pose_icp (3,4) | None) per frame."""
    txt = os.path.join(pred_dir, f"{cls_name}_poses.txt")
    if os.path.exists(txt):
        with open(txt) as f:
            lines = [x.strip() for x in f if x.strip()]
        icp_path = os.path.join(pred_dir, f"{cls_name}_poses_icp.txt")
        icp_lines = None
        if os.path.exists(icp_path):
            with open(icp_path) as f:
                icp_lines = [x.strip() for x in f if x.strip()]
        out = []
        for i, line in enumerate(lines):
            vals = [float(x) for x in line.split()]
            if all(v == -1 for v in vals):
                out.append((None, None))
                continue
            pose = line_to_pose(line)
            icp = line_to_pose(icp_lines[i]) if icp_lines else None
            out.append((pose, icp))
        return out

    import scipy.io as sio
    from scipy.spatial.transform import Rotation as R

    def q2m(pq):
        rot = R.from_quat([pq[1], pq[2], pq[3], pq[0]]).as_matrix()
        return np.concatenate([rot, np.asarray(pq[4:7])[:, None]], axis=1).astype(np.float32)

    out = []
    for i in range(n_frames):
        mat = sio.loadmat(os.path.join(pred_dir, cls_name, f"{i:04d}.mat"))
        labels = np.atleast_1d(np.squeeze(mat["rois"][:, 1]))
        if np.all(labels == -1):
            out.append((None, None))
            continue
        sel = np.where(labels == 1)
        pose = q2m(mat["poses"][sel].reshape(7))
        icp = q2m(mat["poses_icp"][sel].reshape(7)) if "poses_icp" in mat else None
        out.append((pose, icp))
    return out


def gen_posecnn_rendered(
    root: str,
    pred_dir: str,
    classes: list[str] | None = None,
    version: str = "PoseCNN",
    k: np.ndarray = DEFAULT_K,
    batch: int = 8,
    gen_images: bool = True,
    width: int = 640,
    height: int = 480,
    device="cuda",
) -> None:
    dev = resolve_device(device)
    dk = Devkit(root)
    rendered_root = os.path.join(dk.root, "data", f"rendered_val_{version}")
    os.makedirs(dk.pair_set_dir, exist_ok=True)
    for cls_idx, cls_name in resolve_classes(classes).items():
        observed_list = dk.observed_indices(cls_name, "test")
        preds = _load_predictions(pred_dir, cls_name, len(observed_list))
        out_dir = os.path.join(rendered_root, cls_name)
        os.makedirs(out_dir, exist_ok=True)

        pairs, render_jobs = [], []
        for observed_index, (pose, icp) in zip(observed_list, preds):
            if pose is None:
                print(f"no {version} pred for {cls_name} {observed_index}")
                continue
            prefix = observed_index.split("/")[-1]
            name = f"{prefix}_0"
            write_pose_file_with_class(os.path.join(out_dir, f"{name}-pose.txt"), cls_idx, pose)
            write_pose_file_with_class(
                os.path.join(out_dir, f"{name}-pose_icp.txt"), cls_idx,
                icp if icp is not None else pose,
            )
            pairs.append(f"{observed_index} {cls_name}/{name}")
            render_jobs.append((name, pose))

        if gen_images and render_jobs:
            renderer = BatchRenderer(os.path.join(dk.models_dir, cls_name), k, width=width, height=height,
                                     batch=batch, device=dev)
            poses = np.stack([p for _, p in render_jobs])
            for (name, _), (rgb, depth) in zip(render_jobs, renderer.render_many(poses)):
                write_color_png(os.path.join(out_dir, f"{name}-color.png"), rgb)
                write_depth_png(os.path.join(out_dir, f"{name}-depth.png"), depth)
                write_label_png(os.path.join(out_dir, f"{name}-label.png"), (depth != 0).astype(np.uint8) * cls_idx)

        with open(os.path.join(dk.pair_set_dir, f"{version}_val_{cls_name}.txt"), "w") as f:
            f.write("\n".join(pairs) + "\n")
        print(f"{cls_name}: {len(pairs)}/{len(observed_list)} {version} pairs")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--pred-dir", required=True, help="external method predictions")
    ap.add_argument("--classes", nargs="*", default=None)
    ap.add_argument("--version", default="PoseCNN")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    gen_posecnn_rendered(args.root, args.pred_dir, args.classes, args.version, batch=args.batch,
                         device=args.device)


if __name__ == "__main__":
    main()
