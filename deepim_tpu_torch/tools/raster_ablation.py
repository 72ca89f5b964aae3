"""What each part of the CSR raster kernels' design buys, on the card.

    python3 -m deepim_tpu_torch.tools.raster_ablation [other/raster.cu]   # one CUDA device, nvcc

Builds csrc/raster.cu once as the package builds it and once for each
RASTER_ABLATE value (a part of the design switched off; see the source's
header), checks that every variant's output equals the full design's bit
for bit, and times one launch of csr_raster (first sub-batch of the
480x640 batch-16 eval render, 20,480-face meshes), of csr_planes_raster
(the batch-4 training render) and of tile_raster (the batch-2 render of
the 320-face scene; the masks do not touch it) per variant: device time
per launch from CUDA-graph replays (tools/timing.py), the variants taken
in turns, forwards then backwards; for the CSR kernels also a launch of
the longest work item alone, the launch's critical path.  Given the path
of another version of raster.cu (an earlier commit's, with the same C
interface), it builds and times that too, as variant "other".  Prints one
JSON line per kernel.
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
    1: "no cull: every face at all 128 pixels",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("raster_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    k = torch.from_numpy(LINEMOD_K)
    inputs = {}
    for name, batch, detail, active_tiles, csr_kernel in (("csr_raster", 16, 5, 32, "slots8"),
                                                          ("csr_planes_raster", 4, 5, 64, "planes64"),
                                                          ("tile_raster", 2, 2, 64, "slots8")):
        sc = build_scene(batch, 480, 640, LINEMOD_K, num_iters=4, mesh_detail=detail,
                         active_tiles=active_tiles, device=dev)
        m = sc.meshes
        cfg = dataclasses.replace(sc.ecfg.raster, csr_kernel=csr_kernel)
        got, args = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0), k,
                                  cfg, corners=m.corners, corner_colors=m.corner_colors, device=dev)[0]
        assert got == name, got
        inputs[name] = args

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

    def launch(mask, name, args=None):
        rk._lib = libs[mask]  # the wrappers launch whatever library is loaded
        return KERNELS[name](*(inputs[name] if args is None else args))

    for name in inputs:
        ref = launch(0, name)
        for mask in variants:
            if not torch.equal(launch(mask, name), ref):
                raise AssertionError(f"{name}: variant {mask} changes the output")
        ms = {mask: [] for mask in variants}
        for mask in list(variants) + list(variants)[::-1]:
            ms[mask].append(graph_launch_ms(lambda: launch(mask, name)))
        line = {"kernel": name, "card": card,
                "ms": {f"{mask}: {variants[mask]}": ms[mask] for mask in variants}}
        if name != "tile_raster":  # the work list is sorted longest first
            table, unit, *per_item, pack, tile_w = inputs[name]
            first = (table, unit, *(t[:1].contiguous() for t in per_item), pack, tile_w)
            line["longest_item_faces"] = int(per_item[1][0]) * pack
            line["longest_item_ms"] = {f"{mask}: {variants[mask]}": graph_launch_ms(
                lambda: launch(mask, name, first)) for mask in variants}
        print(json.dumps(line), flush=True)
    rk._lib = libs[0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
