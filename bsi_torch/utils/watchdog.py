"""Fail-fast stall detection.

Counterpart of ``bsi_tpu/utils/watchdog.py``. A daemon thread watches a
heartbeat that the training loop touches at every host-synchronisation
point. If no beat arrives within ``timeout_s``, it reports the stall on
stderr and calls ``on_stall``, by default ``os._exit(STALL_EXIT_CODE)``,
which ends the process even when the main thread is blocked in a call that
never returns; the scheduler then requeues from the last checkpoint
(``from_ckpt=<run>/ckpt_last``).

Unlike the JAX package's, the thread checks under a lock that it was not
stopped before it fires, so a run that finished (and stopped its watchdog)
while the thread was between its poll and its exit is not killed; and
:meth:`StallWatchdog.suspended` holds it off around a call that may build
kernels on its first run (the trainer wraps the first call of each path in
it, and beats before every validation).
"""

from __future__ import annotations

import os
import sys
import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

# 70 = BSD EX_SOFTWARE: distinguishes a stall kill from an ordinary crash.
STALL_EXIT_CODE = 70


class StallWatchdog:
    """Daemon-thread heartbeat monitor; fail fast when the loop stops.

    Usage::

        with StallWatchdog(timeout_s=1800) as dog:
            for step in ...:
                ...train step, host fetch...
                dog.beat()

    ``beat()`` marks forward progress. If ``timeout_s`` elapses with no
    beat, ``on_stall()`` runs once from the watchdog thread (default:
    diagnostic to stderr + ``os._exit(STALL_EXIT_CODE)``). ``timeout_s``
    must exceed the longest gap between beats: ``log_every_n_steps`` steps,
    or one eval batch, or one checkpoint's device-to-host copy.
    """

    def __init__(
        self,
        timeout_s: float,
        on_stall: Optional[Callable[[], None]] = None,
        poll_s: Optional[float] = None,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._on_stall = on_stall
        self._poll_s = poll_s if poll_s is not None else min(timeout_s / 4, 15.0)
        self._last = time.monotonic()  # float store/load is atomic under the GIL
        self._stop = threading.Event()
        self._lock = threading.Lock()  # stop() and firing exclude each other
        self._suspended = 0
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, name="stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_s + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def beat(self) -> None:
        """Mark forward progress (call after every host-sync point)."""
        self._last = time.monotonic()

    @contextlib.contextmanager
    def suspended(self) -> Iterator[None]:
        """No stall is reported while the body runs; it beats on both ends."""
        self.beat()
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1
            self.beat()

    @property
    def fired(self) -> bool:
        return self._fired

    def _stalled(self) -> bool:
        return not self._suspended and time.monotonic() - self._last > self.timeout_s

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if self._stalled():
                break
        else:
            return
        with self._lock:
            # stop() may have come since the wait returned: a run that
            # finished is not a stalled one
            if self._stop.is_set() or not self._stalled():
                return
            self._fired = True
            idle = time.monotonic() - self._last
            print(
                f"[watchdog] no training progress for {idle:.0f}s (timeout {self.timeout_s:.0f}s); "
                f"exiting so the scheduler can requeue from the last checkpoint",
                file=sys.stderr,
                flush=True,
            )
            if self._on_stall is not None:
                self._on_stall()
            else:
                os._exit(STALL_EXIT_CODE)
