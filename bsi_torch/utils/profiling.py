"""Tracing a window of training steps.

Counterpart of ``bsi_tpu/utils/profiling.py``: ``trainer.profile_steps``
traces that many steps (from step 10, or a run's last ones where it is
shorter: ``build_task``) with ``torch.profiler``, the CPU and,
on the card, its kernels, and writes a Chrome trace under ``<run>/profile``.
"""

from __future__ import annotations

from pathlib import Path

import torch


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
