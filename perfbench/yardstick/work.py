"""The work of a render, counted from its inputs rather than from the
program's record format, so a kernel that changes its layout is measured
against the same work: each drawable face in view read once as its three
projected corners (u, v, 1/z) and three corner colours (18 float32), each
covered pixel written once (colour and depth, 4 float32), and 22 float32
operations for every (face, pixel) pair that tests inside (2 for the
pixel's offset, 10 for the three edge planes, 4 for the 1/z plane, 2 for
its clamp, 3 for the inside test, 1 for the depth test).  The bound is the
larger of the bytes at HBM bandwidth and the operations at the float32
peak outside the tensor cores."""
from __future__ import annotations

from perfbench.yardstick.flops import HBM_BYTES_S, PEAK_FP32_FLOP_S

FACE_BYTES = 18 * 4
PIXEL_BYTES = 4 * 4
OPS_PER_PAIR = 22


def raster_bound_s(stats: dict) -> float:
    """Least seconds of the renders whose reference render stats
    (perfbench.reference.render's) are given."""
    nbytes = stats["faces_in_view"] * FACE_BYTES + stats["pixels_covered"] * PIXEL_BYTES
    ops = stats["covered_pairs"] * OPS_PER_PAIR
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FP32_FLOP_S)
