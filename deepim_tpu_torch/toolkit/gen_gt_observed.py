"""Render gt-observed color/depth/label per class at the observed GT poses
(counterpart of deepim_tpu/toolkit/gen_gt_observed.py).

Re-implements toolkit/LM6d_0_gen_gt_observed.py: for every index in
image_set/observed/<cls>_<set>.txt, read the class's GT pose from the
observed frame metadata, write gt_observed/<cls>/<prefix>-pose.txt (class
index header), and render depth (always), label (depth != 0), and color.
The reference only kept color for three probe frames (LM6d_0:125-128); here
color is always written unless --probe-color-only is given.

Rendering is batched on the device (BatchRenderer).

    python -m deepim_tpu_torch.toolkit.gen_gt_observed --root <devkit> [--classes C ...]
        [--image-set all] [--probe-color-only] [--batch 8] [--device cuda|cpu]
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
    load_observed_pose,
    resolve_classes,
    write_color_png,
    write_depth_png,
    write_label_png,
    write_pose_file_with_class,
)

PROBE_FRAMES = ("000128", "000256", "000512")  # LM6d_0_gen_gt_observed.py:125


def gen_gt_observed(
    root: str,
    classes: list[str] | None = None,
    image_set: str = "all",
    k: np.ndarray = DEFAULT_K,
    probe_color_only: bool = False,
    batch: int = 8,
    width: int = 640,
    height: int = 480,
    device="cuda",
) -> None:
    dev = resolve_device(device)
    dk = Devkit(root)
    for cls_idx, cls_name in resolve_classes(classes).items():
        indices = dk.observed_indices(cls_name, image_set)
        out_dir = os.path.join(dk.gt_observed_dir, cls_name)
        os.makedirs(out_dir, exist_ok=True)

        poses = []
        for observed_idx in indices:
            pose = load_observed_pose(dk, cls_name, cls_idx, observed_idx)
            prefix = observed_idx.split("/")[-1]
            write_pose_file_with_class(
                os.path.join(out_dir, f"{prefix}-pose.txt"), cls_idx, pose
            )
            poses.append(pose)

        renderer = BatchRenderer(os.path.join(dk.models_dir, cls_name), k, width=width, height=height, batch=batch,
                                 device=dev)
        for observed_idx, (rgb, depth) in zip(indices, renderer.render_many(np.stack(poses))):
            prefix = observed_idx.split("/")[-1]
            write_depth_png(os.path.join(out_dir, f"{prefix}-depth.png"), depth)
            write_label_png(os.path.join(out_dir, f"{prefix}-label.png"), depth != 0)
            if not probe_color_only or any(p in observed_idx for p in PROBE_FRAMES):
                write_color_png(os.path.join(out_dir, f"{prefix}-color.png"), rgb)
        print(f"{cls_name}: {len(indices)} gt_observed frames")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="LM6d_refine devkit root")
    ap.add_argument("--classes", nargs="*", default=None)
    ap.add_argument("--image-set", default="all")
    ap.add_argument("--probe-color-only", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    gen_gt_observed(args.root, args.classes, args.image_set,
                    probe_color_only=args.probe_color_only, batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
