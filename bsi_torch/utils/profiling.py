"""Tracing: a window of training steps, and the program's own spans and counters.

Counterpart of ``bsi_tpu/utils/profiling.py``: ``trainer.profile_steps``
traces that many steps (from step 10, or a run's last ones where it is
shorter: ``build_task``) with ``torch.profiler``, the CPU and,
on the card, its kernels, and writes a Chrome trace under ``<run>/profile``.

The spans and counters record only while a ``torch.profiler`` profile is
active (``torch.autograd._profiler_enabled()``), such as that window; with
none, :func:`span` and :func:`count` cost one flag check. A span keeps its
name, its start and end on the host (``time.time_ns()``), the span it sits
in on its thread, and its attributes, in a list of the process; a span
given a CUDA ``device`` also records a CUDA event on the device's current
stream at entry and exit, resolved into ``device_ms`` when :func:`spans`
reads it, after the caller has synchronised. Each span also enters
``torch.profiler.record_function``, so a trace that records the CPU (that
window's) shows it as a ``user_annotation`` over the kernels; its ``ts`` is
the span's start less the trace's ``baseTimeNanoseconds``, in microseconds,
and so is every event's. Nothing here synchronises while the spans record.

The spans, where the port opens them (the benchmark's per-layer metrics
read them): ``data.batch`` (``ArrayDataModule.train_batches``),
``train.to_device`` (``Trainer._to_device``), ``step`` (the train step, with
attribute ``step``) over ``step.forward``, ``step.backward`` and
``step.update``; ``sample`` (``make_sample_fn``) over ``sample.step``
(``BSI._sample_loop``, attribute ``i``) and ``sample.denoise`` (each
denoiser call of the sampler). Counters: ``ops.<kernel>.<route>``, the calls
of each port op by route, ``kernel`` or ``plain``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

# whether the spans and counters record: while a profiler runs
enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclass
class Span:
    """One recorded span; ``parent`` indexes :func:`spans`' list."""

    name: str
    start_ns: int
    end_ns: Optional[int] = None
    parent: Optional[int] = None
    attrs: dict = field(default_factory=dict)
    events: Optional[tuple] = None  # (entry, exit) CUDA events
    device_ms: Optional[float] = None


class _Open(threading.local):
    def __init__(self):
        self.stack = []


_records: list[Span] = []
_counters: dict[str, int] = {}
_open = _Open()
_lock = threading.Lock()


class _Recording:
    __slots__ = ("record", "device", "range")

    def __init__(self, name: str, device: Optional[torch.device], attrs: dict):
        self.record = Span(name, 0, attrs=attrs)
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        stack = _open.stack
        self.record.parent = stack[-1] if stack else None
        with _lock:
            stack.append(len(_records))
            _records.append(self.record)
        self.record.start_ns = time.time_ns()
        self.range = torch.profiler.record_function(self.record.name)
        self.range.__enter__()
        if self.device is not None:
            self.record.events = (_event(self.device), None)
        return self.record

    def __exit__(self, *exc):
        if self.device is not None:
            self.record.events = (self.record.events[0], _event(self.device))
        self.range.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        _open.stack.pop()
        return False


def _event(device: torch.device):
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def span(name: str, *, device: Optional[torch.device] = None, **attrs):
    """Context of one span ``name`` with attributes ``attrs``; with a CUDA
    ``device``, its device time is taken between events on the device's
    current stream. Records only while a profiler runs."""
    if not enabled():
        return _OFF
    return _Recording(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` while a profiler runs."""
    if enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_call(forward: str, backward: Optional[str], kernel: bool, *inputs: torch.Tensor) -> None:
    """Counts a call of port op ``forward`` (``ops.<op>.kernel``, or
    ``.plain`` for the PyTorch fallback) and, where autograd will take a
    gradient through ``inputs``, of its ``backward`` on the same route."""
    route = "kernel" if kernel else "plain"
    count(f"ops.{forward}.{route}")
    if backward is not None and torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        count(f"ops.{backward}.{route}")


def spans() -> list[Span]:
    """The spans recorded so far, in the order they opened, each device
    span's ``device_ms`` resolved (it waits for the span's exit event)."""
    for record in _records:
        if record.events is not None and record.events[1] is not None and record.device_ms is None:
            record.events[1].synchronize()
            record.device_ms = record.events[0].elapsed_time(record.events[1])
    return list(_records)


def counters() -> dict[str, int]:
    return dict(_counters)


def clear() -> None:
    """Forgets every span and counter; call it with no span open."""
    with _lock:
        _records.clear()
        _counters.clear()


class StepWindowProfiler:
    """Trace a window of training steps (e.g. steps 10..14) once."""

    def __init__(self, log_dir: str | Path, start_step: int = 10, num_steps: int = 5):
        self.log_dir = Path(log_dir)
        self.start_step = start_step
        self.end_step = start_step + num_steps
        self._profile = None
        self._done = False

    @property
    def trace_path(self) -> Path:
        return self.log_dir / "trace.json"

    def on_step(self, step: int) -> None:
        """Call after each step ``step`` (0-based) has been issued."""
        if self._done:
            return
        if self._profile is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profile = torch.profiler.profile(activities=activities)
            self._profile.__enter__()
        elif self._profile is not None and step >= self.end_step:
            self.close()

    def close(self) -> None:
        """Stop a trace in progress and write it."""
        if self._profile is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._profile.__exit__(None, None, None)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._profile.export_chrome_trace(str(self.trace_path))
        self._profile = None
        self._done = True
