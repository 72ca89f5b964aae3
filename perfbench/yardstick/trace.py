"""Reading a torch.profiler trace of a few timed calls: device busy time,
device time by kernel-name family, kernel launches, the top device
operations and the longest idle gaps with what the host was doing.

The families follow chip_smoke._FAMILIES (the first family whose token a
kernel's lower-cased name holds; the rest is "other": elementwise, index,
copies and layout changes), with three corrections: cuDNN's NCHW<->NHWC
layout kernels are "other" (glue), not convolutions; "xmma" no longer marks
a convolution, since cuBLAS's float32 GEMMs carry it too (the zoom's);
"backward" no longer does, since elementwise backward kernels carry it.
Busy time is the union of the device operations' intervals, so the idle
share 1 - busy / wall of chip_smoke.breakdown() cannot read below 0.
"""
from __future__ import annotations

import time

import torch

OTHER = "other"
FAMILIES = (
    ("raster", ("csr_raster", "csr_planes_raster", "tile_raster")),
    ("collectives", ("nccl",)),
    (OTHER, ("nchwtonhwc", "nhwctonchw")),
    ("convolutions", ("conv", "fprop", "implicit", "winograd", "cudnn", "dgrad", "wgrad", "bprop")),
    ("matmuls", ("gemm", "cutlass", "cublas", "bmm")),
    ("sort_scan", ("sort", "radix", "scan")),
)
TOP = 10


def family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, toks in FAMILIES if any(t in low for t in toks)), OTHER)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _traced(fn, n_calls: int, activities) -> tuple[list, list, float]:
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for j in range(n_calls):
            fn(j)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for evt in prof.events():
        if getattr(evt, "is_user_annotation", False):
            continue
        span = (evt.time_range.start, evt.time_range.end)
        (dev if evt.device_type == torch.autograd.DeviceType.CUDA else host).append((span, evt.name))
    return dev, host, wall


def profile(fn, n_calls: int) -> dict:
    """Run fn(j), j = 0 .. n_calls - 1, twice under torch.profiler, each
    pass ending in a synchronize: once tracing the device alone, which
    gives every number but the idle gaps (the wall time with the least of
    the profiler's own host work in it), and once tracing the host too,
    which names what the host did in the longest idle gaps.  Returns
    read()'s reading of the first pass with the second's 'idle_gaps'."""
    from torch.profiler import ProfilerActivity

    dev, _, wall = _traced(fn, n_calls, [ProfilerActivity.CUDA])
    reading = read(dev, [], wall, n_calls)
    dev, host, wall = _traced(fn, n_calls, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    reading["idle_gaps"] = read(dev, host, wall, n_calls)["idle_gaps"]
    return reading


def read(dev: list, host: list, wall_s: float, n_calls: int) -> dict:
    """The reading of device events [((start_us, end_us), name)] and host
    events of the same clock, over wall_s seconds of n_calls calls."""
    fam = {f: 0.0 for f, _ in FAMILIES}
    by_name: dict[str, float] = {}
    launches = 0
    for (a, b), name in dev:
        fam[family(name)] += (b - a) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        launches += not _is_copy(name)
    spans = sorted(s for s, _ in dev)
    busy, gaps = 0.0, []
    cur = None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:TOP]:
        mid = (a + b) / 2
        covering = [(e - s, name) for (s, e), name in host if s <= mid <= e]
        idle.append([min(covering)[1] if covering else "host python", (b - a) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"calls": n_calls, "wall_s": wall_s, "busy_s": busy * 1e-6, "family_s": fam, "launches": launches,
            "op_s": by_name, "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def host_syncs(fn) -> int:
    """The host synchronisations one fn() call makes
    (torch.cuda.set_sync_debug_mode's warnings)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)
