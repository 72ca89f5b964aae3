"""Render the sampled initial poses and write the train/val pair sets
(counterpart of deepim_tpu/toolkit/gen_rendered.py).

Re-implements toolkit/LM6d_2_gen_rendered.py: reads
rendered_poses/LM6d_<set>_rendered_pose_<cls>.txt (quat+trans lines,
per_observed per observed frame), renders color+depth at each pose into
data/rendered/<cls>/<prefix>_<k>-{color,depth}.png with a class-index-header
pose file, and writes the pair sets: observed frames in <cls>_test.txt
contribute their first rendered pose to image_set/my_val_<cls>.txt, all
other frames contribute every rendered pose to image_set/train_<cls>.txt
(LM6d_2:138-156).

    python -m deepim_tpu_torch.toolkit.gen_rendered --root <devkit> [--classes C ...]
        [--image-set all] [--per-observed 10] [--batch 8] [--no-images] [--device cuda|cpu]
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
    write_pose_file_with_class,
)
from deepim_tpu_torch.toolkit.gen_rendered_pose import line_to_pose


def gen_rendered(
    root: str,
    classes: list[str] | None = None,
    image_set: str = "all",
    per_observed: int = 10,
    k: np.ndarray = DEFAULT_K,
    batch: int = 8,
    gen_images: bool = True,
    width: int = 640,
    height: int = 480,
    device="cuda",
) -> None:
    dev = resolve_device(device)
    dk = Devkit(root)
    os.makedirs(dk.pair_set_dir, exist_ok=True)
    for cls_idx, cls_name in resolve_classes(classes).items():
        observed_list = dk.observed_indices(cls_name, image_set)
        try:
            test_list = set(dk.observed_indices(cls_name, "test"))
        except FileNotFoundError:
            test_list = set()
        pose_path = os.path.join(
            dk.rendered_pose_dir, f"LM6d_{image_set}_rendered_pose_{cls_name}.txt"
        )
        with open(pose_path) as f:
            poses = [line_to_pose(x) for x in f if x.strip()]
        assert len(poses) == per_observed * len(observed_list), (
            f"{len(poses)} vs {per_observed * len(observed_list)}"
        )

        out_dir = os.path.join(dk.rendered_dir, cls_name)
        os.makedirs(out_dir, exist_ok=True)
        train_pair, val_pair = [], []
        names = []
        for observed_index in observed_list:
            prefix = observed_index.split("/")[-1]
            for inner in range(per_observed):
                names.append(f"{prefix}_{inner}")
                if observed_index in test_list:
                    if inner == 0:
                        val_pair.append(f"{observed_index} {cls_name}/{prefix}_{inner}")
                else:
                    train_pair.append(f"{observed_index} {cls_name}/{prefix}_{inner}")

        for name, pose in zip(names, poses):
            write_pose_file_with_class(os.path.join(out_dir, f"{name}-pose.txt"), cls_idx, pose)
        if gen_images:
            renderer = BatchRenderer(os.path.join(dk.models_dir, cls_name), k, width=width, height=height,
                                     batch=batch, device=dev)
            for name, (rgb, depth) in zip(names, renderer.render_many(np.stack(poses))):
                write_color_png(os.path.join(out_dir, f"{name}-color.png"), rgb)
                write_depth_png(os.path.join(out_dir, f"{name}-depth.png"), depth)

        with open(os.path.join(dk.pair_set_dir, f"train_{cls_name}.txt"), "w") as f:
            f.write("\n".join(sorted(train_pair)) + "\n")
        with open(os.path.join(dk.pair_set_dir, f"my_val_{cls_name}.txt"), "w") as f:
            f.write("\n".join(sorted(val_pair)) + "\n")
        print(f"{cls_name}: {len(names)} rendered, {len(train_pair)} train / {len(val_pair)} val pairs")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--classes", nargs="*", default=None)
    ap.add_argument("--image-set", default="all")
    ap.add_argument("--per-observed", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-images", action="store_true", help="only pair sets + pose files")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    gen_rendered(args.root, args.classes, args.image_set, args.per_observed,
                 batch=args.batch, gen_images=not args.no_images, device=args.device)


if __name__ == "__main__":
    main()
