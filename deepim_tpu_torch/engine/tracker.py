"""Video pose tracking (PyTorch counterpart of deepim_tpu/engine/tracker.py):
frame t is refined from frame t-1's refined pose.

The JAX tracker is one jitted lax.scan over frames; here the frames are a
Python loop over `refine` that keeps every pose and dropped-pair count on
the device, so the host never waits for the card inside the loop (refine's
own iterations are the only work queued).  The batch dimension carries
independent videos (or objects).
"""
from __future__ import annotations

from typing import Any

import torch

from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, Observation, refine


def make_tracker(model: Any, ecfg: EngineConfig, iters_per_frame: int | None = None,
                 init_iters: int = 0, with_stats: bool = False, device="cuda"):
    """Build the tracking function.

    Returns track(frames, meshes, k, pose0, masks_observed=None):
      frames: (T, B, 3, H, W) RGB [0, 255] video(s), leading time axis
        (a tensor on any device, or a numpy array);
      meshes: MeshBuffers for the B tracked objects;
      k: (3, 3) intrinsics;
      pose0: (B, 3, 4) initial pose for frame 0 (e.g. a PoseCNN estimate);
      masks_observed: optional (T, B, 1, H, W); defaults to full-frame ones
        in the frames' dtype (update_mask='box_rendered' rebuilds the
        observed box from each iteration's render anyway).
    -> (pose_final (B, 3, 4), poses (T, B, 3, 4)), on `device`; with_stats
       adds {'raster_dropped': an int tensor}, the CSR pairs truncated
       over the whole track (0: every render was exact).

    Each frame is refined iters_per_frame times (ecfg.num_iters when None),
    frame 0 included.  init_iters > 0 first refines frame 0 that many extra
    times ("lock-on"), as the reference refines a detection with more
    iterations (TEST.test_iter=4) than frame-to-frame motion needs.

    The whole video is copied to the device before the first frame, as the
    JAX tracker stages it: one transfer, none in the frame loop.  A copy
    from pageable host memory waits for the device, so copying frame by
    frame would stall the host once a frame.  The cost is the video's size
    in device memory (3.7 MB a 480x640 frame in float32).
    """
    n = iters_per_frame if iters_per_frame is not None else ecfg.num_iters
    dev = resolve_device(device)

    def track(frames, meshes: MeshBuffers, k, pose0, masks_observed=None):
        frames = torch.as_tensor(frames).to(dev)
        t, b = frames.shape[:2]
        if masks_observed is None:
            masks_observed = torch.ones((), dtype=frames.dtype, device=dev).expand(t, b, 1, *frames.shape[3:])
        else:
            masks_observed = torch.as_tensor(masks_observed).to(dev)
        meshes = meshes.to(dev)
        k = torch.as_tensor(k).to(dev)
        pose = torch.as_tensor(pose0).to(dev)

        drops = []
        if init_iters:
            obs0 = Observation(frames[0], masks_observed[0], None, None, k)
            pose, _, st0 = refine(model, obs0, meshes, pose, ecfg, init_iters, with_stats=True, device=dev)
            drops.append(st0["raster_dropped"])
        poses = []
        for i in range(t):
            obs = Observation(frames[i], masks_observed[i], None, None, k)
            pose, _, st = refine(model, obs, meshes, pose, ecfg, n, with_stats=True, device=dev)
            poses.append(pose)
            drops.append(st["raster_dropped"])
        poses = torch.stack(poses)
        if with_stats:
            return pose, poses, {"raster_dropped": torch.stack(drops).sum()}
        return pose, poses

    return track


def track_video_sharded(model: Any, frames, meshes: MeshBuffers, k, pose0, ecfg: EngineConfig,
                        mesh=None, iters_per_frame: int | None = None, device="cuda"):
    """Track on one device (mesh=None): the same result as make_tracker.
    Sharding the videos over several devices is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("track_video_sharded over a device mesh is not ported yet "
                                  "(ROADMAP A7, multi-GPU)")
    return make_tracker(model, ecfg, iters_per_frame, device=device)(frames, meshes, k, pose0)
