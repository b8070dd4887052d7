"""The port's stall watchdog and how the trainer drives it: the three faults
found in the JAX package's (each test also shows the JAX package's behaviour
that it guards against), and the ordinary stall."""

import functools
import time

import pytest

from bsi_tpu.utils.watchdog import StallWatchdog as JaxStallWatchdog

from bsi_torch.utils import watchdog as watchdog_module
from bsi_torch.utils.watchdog import StallWatchdog

from torch_tiny import tiny_trainer


def fires_when_stop_lands_after_the_poll(cls) -> bool:
    """Run one watchdog's loop in this thread, its last beat long past, with
    ``stop()`` landing just after its poll returned: does it fire?"""
    fired = []
    dog = cls(1.0, on_stall=lambda: fired.append(True), poll_s=0.01)
    dog._last = time.monotonic() - 100.0

    def wait(timeout=None):
        dog._stop.set()  # the run finished and stopped its watchdog just now
        return False

    dog._stop.wait = wait
    dog._run()
    return bool(fired)


def test_a_watchdog_stopped_after_its_poll_does_not_fire():
    assert fires_when_stop_lands_after_the_poll(JaxStallWatchdog)  # the JAX package's fault
    assert not fires_when_stop_lands_after_the_poll(StallWatchdog)


def test_a_stall_still_fires_and_suspension_holds_it_off():
    fired = []
    dog = StallWatchdog(0.2, on_stall=lambda: fired.append(time.monotonic()), poll_s=0.02).start()
    try:
        with dog.suspended():
            time.sleep(0.5)  # a first call that builds kernels: no stall
        assert not fired
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired and dog.fired
    finally:
        dog.stop()
    with pytest.raises(ValueError):
        StallWatchdog(0)


class Recorder:
    """A watchdog that records beats and suspensions."""

    def __init__(self, events):
        self.events = events

    def beat(self):
        self.events.append("beat")

    def suspended(self):
        import contextlib

        @contextlib.contextmanager
        def body():
            self.events.append("suspend")
            yield
            self.events.append("resume")

        return body()

    def stop(self):
        pass


def test_validate_beats_first_and_holds_off_around_first_calls(tmp_path):
    trainer = tiny_trainer(tmp_path, "trainer.max_steps=1")
    trainer.state = trainer.init_state()
    events = []
    trainer._watchdog = Recorder(events)
    step = trainer._eval_step
    trainer._eval_step = lambda *a: (events.append("eval"), step(*a))[1]
    trainer.validate()
    # a beat before the first eval call; the first call (which may build
    # kernels) inside a suspension, the rest beaten after each batch
    assert events[:4] == ["beat", "suspend", "eval", "resume"]
    assert events.count("suspend") == 1 and events.count("eval") >= 3
    assert events[4:6] == ["beat", "eval"]


def test_a_slow_first_validation_does_not_trip_the_watchdog(tmp_path, monkeypatch):
    # What is tested is the slow first eval call: each stall reported records
    # whether that call was running. Other gaps of the fit (a step, a
    # checkpoint) may outlast the short timeout on a loaded machine, and are
    # not what this test is about.
    slow = {"armed": False, "running": False}
    fired = []
    monkeypatch.setattr(watchdog_module, "StallWatchdog",
                        functools.partial(StallWatchdog, on_stall=lambda: fired.append(slow["running"]),
                                          poll_s=0.05))
    trainer = tiny_trainer(tmp_path, "trainer.max_steps=2", "trainer.val_check_interval=2",
                           "+trainer.stall_timeout_s=2")
    step = trainer._eval_step
    calls = []

    def slow_first(*args):
        calls.append(1)
        if len(calls) == 1:
            slow["armed"] = trainer._watchdog is not None
            slow["running"] = True
            try:
                time.sleep(4.5)  # a cold first eval call, longer than the timeout
            finally:
                slow["running"] = False
        return step(*args)

    trainer._eval_step = slow_first
    trainer.fit()
    assert len(calls) >= 2 and slow["armed"]
    assert True not in fired


def test_stall_timeout_zero_is_refused_not_turned_off(tmp_path):
    # the JAX package reads `stall_timeout_s: 0` as "no watchdog"
    # (bsi_tpu/tasks/task.py: `if trainer_cfg.get("stall_timeout_s")`)
    with pytest.raises(ValueError, match="stall_timeout_s"):
        tiny_trainer(tmp_path, "+trainer.stall_timeout_s=0")
    assert tiny_trainer(tmp_path, "+trainer.stall_timeout_s=30").stall_timeout_s == 30.0
    assert tiny_trainer(tmp_path).stall_timeout_s is None
