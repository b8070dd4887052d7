"""The port's kill-and-requeue soak (``python -m bsi_torch.scripts.soak_test``)
in its small mode on the CPU, as ``tests/test_soak_smoke.py`` runs the JAX
package's: launch ``python -m bsi_torch.train``, SIGTERM it past step 20,
check the interrupt checkpoint and its data cursor, requeue from it, and
check the continuation, the best bpd and the cursor at the end.

The small mode's steps take milliseconds on the CPU, so the run goes on to
step 80: 60 steps and three validations after step 20 give the soak's poll
the time to see step 20 logged before the run ends. Run 1 is killed after
at most a few of its logs, so it has at most four rate windows and the
steps/s drift check is skipped, as the JAX smoke skips it: step rates of a
CPU shared with other test workers are no measure.
"""

import json

from bsi_torch.scripts import soak_test


def test_soak_small_kill_resume_cycle(tmp_path, monkeypatch):
    # One thread a run (each child inherits it): the test workers share the
    # CPU's cores, and children that each start a full team of threads
    # oversubscribe them many times over.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "soak.json"
    timeline = soak_test.main(["--max-steps", "80", "--kill-at", "20", "--small", "--batch", "16", "--n-train", "256",
                               "--device", "cpu", "--root", str(tmp_path / "root"), "--out", str(out)])
    assert json.loads(out.read_text()) == timeline
    events = {e["event"]: e for e in timeline["events"]}
    for name in ("launched", "sigterm_sent", "run1_exited", "interrupt_ckpt_verified", "requeued", "run2_exited",
                 "continuation_verified", "best_monotonic", "rate_stable"):
        assert name in events, (name, list(events))
    assert events["interrupt_ckpt_verified"]["step"] >= 20
    assert events["interrupt_ckpt_verified"]["cursor_examples"] == 16 * events["interrupt_ckpt_verified"]["step"]
    assert events["continuation_verified"]["first_logged"] > events["interrupt_ckpt_verified"]["step"]
    assert events["continuation_verified"]["final_step"] == 80
    # cursor restored: exactly max_steps * batch examples consumed in total
    assert events["continuation_verified"]["cursor_examples"] == 80 * 16
    assert timeline["steps_per_sec"]["run1_windows"] <= 4 and "drift" not in timeline["steps_per_sec"]
