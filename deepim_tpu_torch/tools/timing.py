"""Timing on the card."""
from __future__ import annotations

import statistics

import torch


def graph_launch_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one fn() in ms: `launches` calls captured into one CUDA
    graph, CUDA events around each of `reps` replays, the median over the
    launch count.  The host's share of a call (argument checks, the output
    allocation, the ctypes call: tens of microseconds) stays outside, which
    events around single calls cannot do for a kernel shorter than that.
    fn must enqueue on the current stream and never synchronise; its inputs
    stay in the L2 cache between launches, as they do after the kernels
    that produce them on the render path."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)
