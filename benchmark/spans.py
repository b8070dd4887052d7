"""What the readers of the program's own spans share.

The program records its spans (``bsi_torch/utils/profiling.py``) while a
profiler runs, so in a traced run exactly over the profiled stretch: the
train steps of the stretch, or the profiled sampling call. The readers take
them from the process once the run is over, and divide by the number of
``step`` or ``sample.denoise`` spans they find. A program without the
recorder, or a span without device times (the CPU), gives None.
"""

from __future__ import annotations

INPUT = ("data.batch", "train.to_device")


def recorded() -> list:
    """The program's spans of this process, ``[]`` where it records none."""
    try:
        from bsi_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def _count(spans: list, per: str) -> int:
    return sum(1 for s in spans if s.name == per)


def device_ms(spans: list, name: str, per: str):
    """Device ms of the ``name`` spans, summed, over the number of ``per`` spans."""
    times = [s.device_ms for s in spans if s.name == name]
    n = _count(spans, per)
    if not n or not times or any(t is None for t in times):
        return None
    return sum(times) / n


def host_ms(spans: list, names: tuple, per: str):
    """Host ms inside the ``names`` spans, summed, over the number of ``per`` spans."""
    ns = [s.end_ns - s.start_ns for s in spans if s.name in names and s.end_ns is not None]
    n = _count(spans, per)
    return sum(ns) / 1e6 / n if n and ns else None


def innermost(spans: list, t_ns: float):
    """The innermost span open at ``t_ns`` on the spans' clock, or None
    (spans come in the order they opened, so a later one that holds the
    time lies inside an earlier one)."""
    return next((s for s in reversed(spans) if s.end_ns is not None and s.start_ns <= t_ns <= s.end_ns), None)


def idle_ms(trace, spans: list, names: tuple, per: str):
    """Idle ms of ``trace``'s holes whose midpoint lies inside a ``names``
    span, over the number of ``per`` spans; None without a trace of device
    operations, its base, or such spans."""
    inside = [(s.start_ns, s.end_ns) for s in spans if s.name in names and s.end_ns is not None]
    n = _count(spans, per)
    if trace is None or trace.busy_s <= 0 or trace.base_ns is None or not inside or not n:
        return None
    held = lambda t: any(lo <= t <= hi for lo, hi in inside)
    return sum(b - a for a, b in trace.holes if held(trace.span_ns((a + b) / 2))) / 1e3 / n
