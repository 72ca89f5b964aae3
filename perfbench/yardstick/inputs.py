"""The inputs both sides get, made from the run's seed: the network's
weights (on the device, in a few large draws), the configuration's numbers
for the reference, and each pool batch's tensors (observed images, depths
and masks rendered by the plain renderer at the ground-truth poses)."""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.render import render
from perfbench.reference.zoom import box_fill
from perfbench.yardstick.traffic import make_pool


def spec_of(config: dict) -> dict:
    """The numbers of a configuration file's `config` section that the
    reference and the inputs need, as plain values and tensors on the CPU."""
    c = config
    ds, nw, ti, tr = c["dataset"], c["network"], c["train_iter"], c["TRAIN"]
    h, w = c["SCALES"]
    return {
        "height": h, "width": w,
        "k": torch.tensor(ds["INTRINSIC_MATRIX"], dtype=torch.float32).reshape(3, 3),
        "znear": ds["ZNEAR"], "zfar": ds["ZFAR"],
        "pixel_means": torch.tensor(nw["PIXEL_MEANS"], dtype=torch.float32),
        "normalize_flow": ds["NORMALIZE_FLOW"], "normalize_3d_point": ds["NORMALIZE_3D_POINT"],
        "LW_PM": ti["LW_PM"], "NUM_3D_SAMPLE": ti["NUM_3D_SAMPLE"], "LW_FLOW": ti["LW_FLOW"],
        "LW_MASK": ti["LW_MASK"], "lr": tr["lr"], "warmup_lr": tr["warmup_lr"] if tr["warmup"] else tr["lr"],
        "warmup_step": tr["warmup_step"] if tr["warmup"] else 0, "momentum": tr["momentum"], "wd": tr["wd"],
        "grad_clip": tr["grad_clip"], "iters_test": c["TEST"]["test_iter"],
        "iters_train": nw["TRAIN_ITER_SIZE"],
    }


def spec_to(spec: dict, device) -> dict:
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in spec.items()}


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Seeded float32 weights, named as the network's state dict: LeCun
    normal convolutions (truncated at 2 deviations), Xavier-uniform fc6 and
    fc7, the quaternion head near the identity (w column U(0.01, 1.01), the
    rest U(0, 0.01)), the translation head N(0, 1e-3) (chip_smoke's
    make_model: poses move and stay in view), the mask head N(0, 0.01),
    zero biases.  Two draws on the device, one normal and one uniform."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = [n for n, s in shapes.items() if len(s) == 4 or n == "trans.weight"]
    uniform = [n for n, s in shapes.items() if n in ("fc6.weight", "fc7.weight", "rot.weight")]
    zn = torch.randn(sum(math.prod(shapes[n]) for n in normal), generator=g, device=device)
    zu = torch.rand(sum(math.prod(shapes[n]) for n in uniform), generator=g, device=device)
    out, i = {}, 0
    for n in normal:
        s = shapes[n]
        x = zn[i:i + math.prod(s)].reshape(s)
        i += x.numel()
        if n == "trans.weight":
            out[n] = x * 1e-3
        elif n == "mask_conv3.weight":
            out[n] = x * 0.01
        else:
            fan_in = (s[0] if ".deconv." in n else s[1]) * s[2] * s[3]
            out[n] = torch.clamp(x, -2.0, 2.0) * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)
    i = 0
    for n in uniform:
        s = shapes[n]
        x = zu[i:i + math.prod(s)].reshape(s)
        i += x.numel()
        if n == "rot.weight":
            x = x * 0.01
            x[0::4] = x[0::4] * 100.0 + 0.01
            out[n] = x
        else:
            bound = math.sqrt(6.0 / (s[0] + s[1]))
            out[n] = x * (2 * bound) - bound
    for n, s in shapes.items():
        if n not in out:
            out[n] = torch.zeros(s, device=device)
    return {n: out[n].contiguous() for n in shapes}


def make_batches(spec: dict, bank: tuple, n_vertices: np.ndarray, traffic: dict, batch: int, seed: int,
                 device, points: int = 0) -> list[dict]:
    """The traffic's pool as tensors on `device`: per batch its mesh rows
    ('mesh': vertices, colors, faces, face_valid), 'class_index',
    'pose_gt', 'pose0' (the initial pose), 'image_observed' (B, 3, H, W)
    in [0, 255], 'depth_gt_observed' (B, H, W), 'mask_gt_observed' and
    'mask_observed' (its box) (B, 1, H, W); with `points`, 'points_model'
    (B, points, 3), that many vertices of each sample's mesh drawn from the
    seed, and 'points_weights' (B, points)."""
    k = spec["k"].numpy()
    pool = make_pool(traffic, batch, len(n_vertices), k, seed)
    bank_d = [torch.from_numpy(a).to(device) for a in bank]
    sp = spec_to(spec, device)
    rng = np.random.default_rng([seed, 3])
    out = []
    for p in pool:
        cls = torch.from_numpy(p["class_index"]).to(device)
        mesh = dict(zip(("vertices", "colors", "faces", "face_valid"), (a[cls] for a in bank_d)))
        pose_gt = torch.from_numpy(p["pose_gt"]).to(device)
        rgb, depth = render(mesh["vertices"], mesh["colors"], mesh["faces"], mesh["face_valid"], pose_gt,
                            sp["k"], sp["height"], sp["width"], sp["znear"], sp["zfar"])
        mask = (depth > 0.2).float()
        b = {"mesh": mesh, "class_index": cls, "pose_gt": pose_gt, "pose0": torch.from_numpy(p["pose0"]).to(device),
             "image_observed": rgb, "depth_gt_observed": depth[:, 0], "mask_gt_observed": mask,
             "mask_observed": box_fill(mask)}
        if points:
            idx = np.stack([rng.choice(n_vertices[c], points, replace=n_vertices[c] < points)
                            for c in p["class_index"]])
            idx_t = torch.from_numpy(idx).to(device)
            b["points_model"] = torch.gather(mesh["vertices"], 1, idx_t[..., None].expand(-1, -1, 3))
            b["points_weights"] = torch.ones(idx.shape, device=device)
        out.append(b)
    return out
