"""What each part of the raster kernels' design buys, on the card.

    python3 -m deepim_tpu_torch.tools.raster_ablation [other/raster.cu]   # one CUDA device, nvcc

Builds csrc/raster.cu once as the package builds it and once for each
RASTER_ABLATE value (a part of the design switched off; see the source's
header), checks that every variant's output equals the full design's bit
for bit, and times one launch of csr_raster (first sub-batch of the
480x640 batch-16 eval render, 20,480-face meshes), of csr_planes_raster
(the batch-4 training render) and of tile_raster at two shapes (light:
the batch-2 render of the 320-face scene; heavy: batch 16 of 1,280-face
icospheres with lists of up to 512 faces) per variant: device time per
launch from CUDA-graph replays (tools/timing.py), the variants taken in
turns, forwards then backwards; also a launch of the longest work item
alone, the launch's critical path, and for tile_raster what the cull
leaves of that item (dense_item_facts).  Given the path of another version of
raster.cu (an earlier commit's, with the same C interface), it builds and
times that too, as variant "other".  Prints one JSON line per kernel and
shape.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from deepim_tpu_torch.engine.scene import LINEMOD_K, build_scene
from deepim_tpu_torch.render import raster_kernels as rk
from deepim_tpu_torch.render.rasterizer import KERNELS, kernel_inputs
from deepim_tpu_torch.tools.timing import graph_launch_ms

VARIANTS = {
    0: "full design",
    1: "no cull: every face at every pixel of its tile",
}


def dense_item_facts(records, ids, counts, tile_xy, tile_h, tile_w) -> dict:
    """What tile_raster's cull and z-test find in one work item (the plain
    versions on the card): the (face, 16-pixel block) pairs the cull keeps,
    the mean and the longest list of a block that has one, and the pixels
    of the tile a listed face covers on average."""
    rec = records[ids[0, :int(counts[0])].long()]
    x0, y0 = int(tile_xy[0, 0]), int(tile_xy[0, 1])
    live = torch.stack([(rk.edge_maxima_plain(rec, x0 + x_lo, x0 + x_hi, y0 + y_lo, y0 + y_hi) >= 0).all(-1)
                        for x_lo, x_hi, y_lo, y_hi in rk.cull_rectangles(tile_w, tile_h=tile_h)])  # (blocks, faces)
    per_block = live.sum(1)
    inside, _ = rk._coverage(rec[None], *rk._pixel_coords(tile_xy[:1], tile_h * tile_w, tile_w))
    return {"live_pairs": int(live.sum()), "blocks_with_faces": int((per_block > 0).sum()),
            "mean_block_list": round(float(per_block[per_block > 0].float().mean()), 2),
            "longest_block_list": int(per_block.max()),
            "covered_pixels_per_face": round(float(inside[0].sum(1).float().mean()), 2)}


def main() -> int:
    if not torch.cuda.is_available():
        print("raster_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    k = torch.from_numpy(LINEMOD_K)
    inputs = {}  # (kernel, shape) -> its arguments
    for name, shape, batch, detail, active_tiles, csr_kernel, k_cap in (
            ("csr_raster", "", 16, 5, 32, "slots8", 128), ("csr_planes_raster", "", 4, 5, 64, "planes64", 128),
            ("tile_raster", "light", 2, 2, 64, "slots8", 128), ("tile_raster", "heavy", 16, 3, 64, "slots8", 512)):
        sc = build_scene(batch, 480, 640, LINEMOD_K, num_iters=4, mesh_detail=detail,
                         max_faces_per_tile=k_cap, active_tiles=active_tiles, device=dev)
        m = sc.meshes
        cfg = dataclasses.replace(sc.ecfg.raster, csr_kernel=csr_kernel)
        got, args = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0), k,
                                  cfg, corners=m.corners, corner_colors=m.corner_colors, device=dev)[0]
        if got != name:
            raise AssertionError(f"scene meant for {name} plans {got}")
        inputs[name, shape] = args

    variants = dict(VARIANTS)
    libs = {}
    for mask in VARIANTS:
        libs[mask], seconds, log, _ = rk.build_library((f"-DRASTER_ABLATE={mask}",) if mask else ())
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] RASTER_ABLATE={mask}: nvcc {seconds:.2f} s; {usage}", flush=True)
    if len(sys.argv) > 1:
        variants["other"] = sys.argv[1]
        libs["other"], seconds, log, _ = rk.build_library(source=sys.argv[1])
        print(f"[build] {sys.argv[1]}: nvcc {seconds:.2f} s", flush=True)

    def launch(mask, name, args):
        rk._lib = libs[mask]  # the wrappers launch whatever library is loaded
        return KERNELS[name](*args)

    for (name, shape), args in inputs.items():
        label = f"{name} {shape}".strip()
        ref = launch(0, name, args)
        for mask in variants:
            if not torch.equal(launch(mask, name, args), ref):
                raise AssertionError(f"{label}: variant {mask} changes the output")
        ms = {mask: [] for mask in variants}
        for mask in list(variants) + list(variants)[::-1]:
            ms[mask].append(graph_launch_ms(lambda: launch(mask, name, args)))
        line = {"kernel": label, "card": card,
                "ms": {f"{mask}: {variants[mask]}": ms[mask] for mask in variants}}
        # The longest item alone (the work list is sorted longest first).
        if name == "tile_raster":
            records, ids, counts, tile_xy, tile_h, tile_w = args
            first = (records, ids[:1].contiguous(), counts[:1].contiguous(), tile_xy[:1].contiguous(),
                     tile_h, tile_w)
            line["longest_item_faces"] = int(counts[0])
            line["longest_item_facts"] = dense_item_facts(*first)
        else:
            table, unit, *per_item, pack, tile_w = args
            first = (table, unit, *(t[:1].contiguous() for t in per_item), pack, tile_w)
            line["longest_item_faces"] = int(per_item[1][0]) * pack
        line["longest_item_ms"] = {f"{mask}: {variants[mask]}": graph_launch_ms(
            lambda: launch(mask, name, first)) for mask in variants}
        print(json.dumps(line), flush=True)
    rk._lib = libs[0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
