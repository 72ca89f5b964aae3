"""A cell shrunk to run on the CPU in seconds: 64x64 frames with LINEMOD's
focal lengths scaled alike, subdivision-4 meshes (5,120 faces: the CSR
path, as at full size), small batches."""
from __future__ import annotations

from perfbench import harness

SIZE = 64


def tiny_cell(name: str, batch: int = 4, pool: int = 4, root=harness.HERE) -> harness.Cell:
    c = harness.load_cell(name, root)
    cfg = c.config["config"]
    cfg["SCALES"] = [SIZE, SIZE]
    s = SIZE / 640.0
    k = cfg["dataset"]["INTRINSIC_MATRIX"]
    cfg["dataset"]["INTRINSIC_MATRIX"] = [k[0] * s, 0.0, SIZE / 2, 0.0, k[4] * s, SIZE / 2, 0.0, 0.0, 1.0]
    cfg["TRAIN"]["BATCH_PAIRS"] = batch
    c.config["meshes"].update(subdiv=4, fine_subdiv=[4])
    c.traffic.update(center_px=[[SIZE * 0.4, SIZE * 0.6], [SIZE * 0.4, SIZE * 0.6]], pool=pool)
    if "batch" in c.traffic:
        c.traffic["batch"] = batch
    return c
