"""Spans at the port's layer boundaries: the host and device time of each
refine call and training step, on one clock.

    from deepim_tpu_torch.utils import tracing

    with tracing.span("render", dev):
        ...

Tracing is off by default: `span()` then returns one shared no-op context
after a flag check, and records, allocates and calls nothing in torch.  It
is on after `enable()`, or while a torch.profiler session records (torch's
own `_is_profiler_enabled` flag), so a profiler trace holds every span.

When on, each span records its name, an id, its parent's id and the id of
its call (the outermost open span of its thread); its host interval on
time.perf_counter_ns; on a CUDA `device`, its device interval from two
timing events recorded on the current stream, taken from a reused pool;
and while a profiler session records, it runs as
torch.profiler.record_function(name), which puts it in the profiler's
trace on the clock of the kernels it launched.  Device times are
put on the host's clock by one anchor event per card, recorded after a
synchronize when the card is first traced (after each enable() or
reset()): a device time is the anchor's host time plus the event's
elapsed_time from the anchor.  A span opened directly inside an open span
of the same name is part of it (re-entrant spans: a driver may open
`refine.call` around a stage that calls refine()).

The spans of the last MAX_CALLS calls are kept in a ring; totals by span
name (count, host ms, host self ms, device ms, device self ms; self time is
a span's duration less what its child spans cover) cover every span since
reset().  Device events are resolved when calls(), totals(), snapshot() or
write() read them (one synchronize per card), or when a call leaves the
ring, never while a span opens or closes.

`count(name, n)` adds to a counter of the innermost open span and to a
total; snapshot() also reads the raster kernels' own launch counters
(render/raster_kernels.py).  `write(path)` writes the kept calls as one
Chrome-trace JSON (chrome://tracing, Perfetto): a host and a device lane for
each thread, the counters as arguments.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_CALLS = 256  # calls kept for calls() and write(); totals cover all

_enabled = False


class _Off:
    """The context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_local = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_ring: collections.deque = collections.deque()
_totals: dict[str, list] = {}   # name -> [count, host ns, host self ns, device ns, device self ns, device count]
_counters: dict[str, int] = {}
_anchors: dict[int, tuple] = {}  # card index -> (event, host ns)
_pool: dict[int, list] = {}      # card index -> free timing events


def span(name: str, device: torch.device | None = None):
    """A context that records one span while tracing is on.  `device`: the
    torch.device the span's work runs on; its device interval is timed on a
    CUDA device only."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    stack = _stack()
    if stack and stack[-1].name == name:
        return _OFF
    return _Span(name, device, stack)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost open span of this thread
    and to its total; nothing while tracing is off."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        counters = stack[-1].counters
        if counters is None:
            counters = stack[-1].counters = {}
        counters[name] = counters.get(name, 0) + n
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Turn tracing on (until disable()); the cards are anchored anew at
    their next span."""
    global _enabled
    with _lock:
        _anchors.clear()
    _enabled = True


def disable() -> None:
    """Turn off what enable() turned on (a profiler session still turns
    the spans on)."""
    global _enabled
    _enabled = False


def is_on() -> bool:
    """Whether span() records now."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def reset() -> None:
    """Forget every kept call, total, counter and anchor."""
    with _lock:
        _ring.clear()
        _totals.clear()
        _counters.clear()
        _anchors.clear()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event(index: int):
    try:
        return _pool[index].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


def _anchor(device: torch.device) -> tuple:
    """The card's anchor: an event recorded right after a synchronize, and
    the host clock read at that moment."""
    with _lock:
        if device.index not in _anchors:
            torch.cuda.synchronize(device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            _anchors[device.index] = (ev, time.perf_counter_ns())
        return _anchors[device.index]


class _Span:
    __slots__ = ("name", "id", "parent", "call", "thread", "t0", "t1", "host_self", "child_host",
                 "device", "anchor", "ev0", "ev1", "d0", "d1", "child_dev", "counters", "spans", "_rf", "_stack")

    def __init__(self, name: str, device, stack: list):
        self.name = name
        self._stack = stack
        self.device = device if device is not None and device.type == "cuda" else None
        self.anchor = self.ev0 = self.ev1 = self.d0 = self.d1 = None
        self.child_host = self.child_dev = 0
        self.counters = None
        self._rf = None

    def __enter__(self):
        stack = self._stack
        self.id = next(_ids)
        self.thread = threading.get_ident()
        if stack:
            root, parent = stack[0], stack[-1]
            self.parent, self.call = parent.id, root.id
            root.spans.append(self)
            self.spans = None
        else:
            self.parent, self.call = None, self.id
            self.spans = [self]
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.device is not None:
            self.anchor = _anchors.get(self.device.index) or _anchor(self.device)
            self.ev0 = _event(self.device.index)
            self.ev0.record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.device is not None:
            self.ev1 = _event(self.device.index)
            self.ev1.record(torch.cuda.current_stream(self.device))
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = self._stack
        stack.pop()
        self.t1 = t1
        dur = t1 - self.t0
        self.host_self = dur - self.child_host
        if stack:
            stack[-1].child_host += dur
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0, 0, 0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += self.host_self
            if not stack:
                _ring.append(self)
                while len(_ring) > MAX_CALLS:
                    _resolve(_ring.popleft())
        return False


def _resolve(root: _Span) -> None:
    """Put the device intervals of root's call on the host clock, add them
    to the totals and give the events back to the pool.  Under _lock; the
    events are complete (the caller synchronized, or the call is old)."""
    spans = root.spans
    if root.ev1 is not None:
        root.ev1.synchronize()
    by_id = {}
    for s in spans:
        if s.ev0 is None:
            continue
        ev, host_ns = s.anchor
        s.d0 = host_ns + round(ev.elapsed_time(s.ev0) * 1e6)
        s.d1 = host_ns + round(ev.elapsed_time(s.ev1) * 1e6)
        by_id[s.id] = s
        _pool.setdefault(s.device.index, []).extend((s.ev0, s.ev1))
        s.ev0 = s.ev1 = None
    for s in by_id.values():
        parent = by_id.get(s.parent)
        if parent is not None:
            parent.child_dev += s.d1 - s.d0
    for s in by_id.values():
        tot = _totals[s.name]
        tot[3] += s.d1 - s.d0
        tot[4] += s.d1 - s.d0 - s.child_dev
        tot[5] += 1


def _resolve_ring() -> None:
    with _lock:
        pending = [r for r in _ring if any(s.ev0 is not None for s in r.spans)]
        for index in {s.device.index for r in pending for s in r.spans if s.device is not None}:
            torch.cuda.synchronize(index)
        for r in pending:
            _resolve(r)


def _ms(ns):
    return None if ns is None else ns * 1e-6


def calls() -> list[dict]:
    """The kept calls, oldest first: {'id', 'name', 'thread', 'spans'}, the
    spans in the order they opened, each {'name', 'id', 'parent', 'call',
    'thread', 'host_start_ns', 'host_end_ns', 'host_ms', 'host_self_ms',
    'device_start_ns', 'device_end_ns', 'device_ms', 'device_self_ms',
    'counters'} (the device entries None without a CUDA device)."""
    _resolve_ring()
    with _lock:
        roots = list(_ring)
    out = []
    for root in roots:
        spans = []
        for s in root.spans:
            dev = None if s.d0 is None else s.d1 - s.d0
            spans.append({
                "name": s.name, "id": s.id, "parent": s.parent, "call": s.call, "thread": s.thread,
                "host_start_ns": s.t0, "host_end_ns": s.t1, "host_ms": _ms(s.t1 - s.t0),
                "host_self_ms": _ms(s.host_self), "device_start_ns": s.d0, "device_end_ns": s.d1,
                "device_ms": _ms(dev), "device_self_ms": None if dev is None else _ms(dev - s.child_dev),
                "counters": dict(s.counters) if s.counters else {},
            })
        out.append({"id": root.id, "name": root.name, "thread": root.thread, "spans": spans})
    return out


def totals() -> dict[str, dict]:
    """By span name, over every span since reset(): 'count', 'host_ms',
    'host_self_ms', 'device_ms', 'device_self_ms' (device time of the spans
    resolved so far: the kept calls and those that left the ring; None
    for a name never timed on a device)."""
    _resolve_ring()
    with _lock:
        return {name: {"count": t[0], "host_ms": _ms(t[1]), "host_self_ms": _ms(t[2]),
                       "device_ms": _ms(t[3]) if t[5] else None, "device_self_ms": _ms(t[4]) if t[5] else None}
                for name, t in _totals.items()}


def snapshot() -> dict:
    """totals(), the counters' totals and the raster kernels' launch
    counters (`launches` of each wrapper in render/raster_kernels.py)."""
    from deepim_tpu_torch.render import raster_kernels

    with _lock:
        counters = dict(_counters)
    return {"totals": totals(), "counters": counters,
            "raster_launches": {w.__name__: w.launches for w in (
                raster_kernels.csr_raster, raster_kernels.csr_planes_raster, raster_kernels.tile_raster)}}


def layer_ms(kept: list[dict], names, clock: str = "host", outside: bool = False) -> float | None:
    """The mean over `kept` (calls() entries) of the ms a call spends on
    `clock` ('host' or 'device') inside spans named in `names`, a span
    inside another of them counted once; with `outside`, inside the call's
    outermost span but outside those spans.  None without calls, or when a
    call's outermost span has no interval on that clock."""
    if not kept:
        return None
    lo, hi = ("host_start_ns", "host_end_ns") if clock == "host" else ("device_start_ns", "device_end_ns")
    names = set(names)
    total = 0
    for call in kept:
        spans = call["spans"]
        root = spans[0]
        if root[lo] is None:
            return None
        inside_ids = set()
        inside = 0
        for s in spans:
            if s["parent"] in inside_ids:
                inside_ids.add(s["id"])
            elif s["name"] in names:
                inside_ids.add(s["id"])
                if s[lo] is not None:
                    inside += s[hi] - s[lo]
        total += (root[hi] - root[lo] - inside) if outside else inside
    return total / len(kept) * 1e-6


def write(path: str) -> None:
    """The kept calls as Chrome-trace JSON: for each thread a host lane and
    a device lane (device intervals on the host's clock), each span an
    event whose args hold its id, parent, call and counters; the snapshot
    under 'otherData'."""
    kept = calls()
    pid = os.getpid()
    lanes: dict[int, int] = {}
    events = []
    for call in kept:
        for s in call["spans"]:
            if s["thread"] not in lanes:
                lane = lanes[s["thread"]] = 2 * len(lanes)
                for tid, kind in ((lane, "host"), (lane + 1, "device")):
                    events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                                   "args": {"name": f"{kind} {s['thread']}"}})
            lane = lanes[s["thread"]]
            args = {"id": s["id"], "parent": s["parent"], "call": s["call"], **s["counters"]}
            events.append({"name": s["name"], "cat": "host", "ph": "X", "pid": pid, "tid": lane,
                           "ts": s["host_start_ns"] / 1e3, "dur": (s["host_end_ns"] - s["host_start_ns"]) / 1e3,
                           "args": args})
            if s["device_start_ns"] is not None:
                events.append({"name": s["name"], "cat": "device", "ph": "X", "pid": pid, "tid": lane + 1,
                               "ts": s["device_start_ns"] / 1e3,
                               "dur": (s["device_end_ns"] - s["device_start_ns"]) / 1e3, "args": args})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms", "otherData": snapshot()}, f)
