"""A profiled stretch of a run's window, read from ``torch.profiler``'s trace.

:class:`Stretch` records the device's activity (CUDA only: recording every
CPU operation as well more than halves the pace of a host-paced step, so
the idle share would describe the profiler) over a part of the window that
starts with the device idle and ends with a synchronise; the trace is
exported and read after the stretch, outside the timed calls. :func:`read`
turns it into the device's busy time (the union of every kernel's, copy's
and set's interval), the time by kind of kernel (:mod:`.kinds`), and the
longest idle gaps between device operations, each labelled with the CUDA
call the host was in at the gap's middle, or else with the kind of the
device operation that ended it. It keeps every idle hole's place, and the
exported trace's ``baseTimeNanoseconds``: a trace's ``ts`` (µs) is the
host's ``time.time_ns()`` less that base, over 1e3, which is the clock of
the program's spans (:meth:`Trace.span_ns`).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from . import kinds

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver")
GAPS = 10  # the longest idle gaps kept, as the result's breakdown holds them


class Stretch:
    """``start()`` when the device is idle, ``close()`` at the stretch's end
    (it synchronises), ``read()`` once the timed work is over."""

    def __init__(self, dev):
        self.dev = dev
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA] if dev.cuda else
                                           [torch.profiler.ProfilerActivity.CPU])
        self.window_s = None

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()

    def close(self) -> None:
        self.dev.sync()
        self.window_s = time.perf_counter() - self.t0

    def read(self) -> "Trace":
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                exported = json.load(f)
            return read(exported["traceEvents"], self.window_s, exported.get("baseTimeNanoseconds"))
        finally:
            os.unlink(path)


def warm(dev) -> None:
    """Starts and stops the profiler once: its first start, which sets up
    CUPTI, then falls in set-up and not in the window."""
    prof = Stretch(dev).prof
    prof.start()
    dev.sync()
    prof.stop()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    by_kind: dict = field(default_factory=dict)  # kind -> seconds
    gaps: list = field(default_factory=list)  # [(label, seconds)], longest first
    holes: list = field(default_factory=list)  # [(start, end)] of every idle hole in µs, longest first
    base_ns: int | None = None  # the trace's baseTimeNanoseconds

    def span_ns(self, us: float) -> float:
        """A time of the trace (µs) on the spans' clock (ns)."""
        return self.base_ns + us * 1e3


def _union(intervals):
    merged = []
    for lo, hi, k in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi, k])
    return merged


def read(events: list, window_s: float, base_ns: int | None = None) -> Trace:
    by_kind: dict = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        k = kinds.kind(e["name"], e["cat"])
        spans.append((e["ts"], e["ts"] + e["dur"], k))
        by_kind[k] = by_kind.get(k, 0.0) + e["dur"] / 1e6
    merged = _union(spans)
    busy = sum(b - a for a, b, _ in merged) / 1e6
    holes = sorted(((a[1], b[0], b[2]) for a, b in zip(merged[:-1], merged[1:])), key=lambda h: h[0] - h[1])
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES]
    gaps = []
    for a, b, after in holes[:GAPS]:
        mid = (a + b) / 2
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        label = max(inside, key=lambda e: e["ts"])["name"] if inside else f"host, before {after}"
        gaps.append((label, (b - a) / 1e6))
    return Trace(window_s=window_s, busy_s=busy, by_kind=by_kind, gaps=gaps, holes=[(a, b) for a, b, _ in holes],
                 base_ns=base_ns)
