"""Preemption handling for requeueable training jobs.

Counterpart of ``bsi_tpu/utils/preemption.py``: SIGTERM and SIGUSR1 set a
flag that the training loop polls between steps; the loop then saves
``ckpt_interrupt`` and returns, so the scheduler can requeue the job with
``from_ckpt=<run_dir>/ckpt_interrupt``.
"""

from __future__ import annotations

import signal
import sys
from typing import Iterable


class PreemptionHandler:
    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGUSR1)):
        self.triggered = False
        self._signals = tuple(signals)
        self._previous: dict[int, object] = {}

    def _handle(self, signum, frame):
        self.triggered = True
        print(f"[preemption] received signal {signum}; will checkpoint and exit", file=sys.stderr)

    def install(self) -> "PreemptionHandler":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
