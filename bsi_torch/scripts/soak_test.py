"""Kill-and-requeue soak: a CIFAR-recipe run with a SIGTERM in the middle.

    python -m bsi_torch.scripts.soak_test [--max-steps 50000] [--kill-at 25000] [--batch 128]
        [--n-train 50000] [--small] [--device cpu] [--root DIR] [--out FILE]

Counterpart of ``scripts/soak_test.py``. Drives the port's entry point,
``python -m bsi_torch.train``, in a subprocess on synthetic CIFAR-shaped
data through a preemption and requeue:

1. launch it (the CIFAR-10 recipe's model: UNet dim 128 x 32 levels,
   dropout 0.1) for ``--max-steps`` steps;
2. poll the run's ``metrics.jsonl``; once it has logged ``--kill-at`` steps,
   send SIGTERM to the child by its pid, as a scheduler's maintenance event
   would (``bsi_torch/utils/preemption.py`` catches it);
3. assert the child exits 0 after writing ``ckpt_interrupt`` at or past the
   kill step, with the data cursor exactly ``step * batch`` examples in;
4. requeue: launch again with ``from_ckpt=<run>/ckpt_interrupt``;
5. assert the resumed run continues (its first logged step follows the
   interrupt step, its cursor ends at exactly ``max_steps * batch``),
   ``best/bpd`` never rises across both runs, and the median steps/s of the
   two runs (each run's first two rate windows skipped, and only where each
   run has more than four) differ by under 15 %.

Writes the timeline (events, and both runs' median steps/s and their
drift) as JSON to ``--out``. ``--small`` is a smoke run on the CPU: the
model cut to dim 32 x 2 levels, the images to 8x8, the val split to 32
images and the eval batch to 16 (``--max-steps 80 --kill-at 20 --small
--batch 16 --n-train 256 --device cpu``: the steps past the kill leave the
poll time to see step 20). The run is on the card unless ``--device cpu``
appends ``+trainer.device=cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from bsi_torch.core.common import resolve_device
from bsi_torch.scripts._common import REPO_ROOT

# Seconds between two reads of metrics.jsonl. A step of the --small run on
# the CPU takes milliseconds, so a coarser poll could see the run end before
# it sends the signal.
POLL_S = 0.1


def _overrides(args, root: Path) -> list[str]:
    ov = [
        "task=bsi",
        "task.model=unet",
        "task.optimizer.lr=2e-4",
        "task.optimizer.weight_decay=1e-2",
        "data=synthetic",
        f"data.n_train={args.n_train}",
        "data.n_val=512",
        "data.data_shape=[32, 32, 3]",
        f"data.batch_size={args.batch}",
        "data.eval_batch_size=256",
        f"trainer.max_steps={args.max_steps}",
        f"trainer.val_check_interval={max(args.max_steps // 4, 10)}",
        "trainer.limit_eval_batches=2",
        "trainer.log_every_n_steps=10",
        "trainer.plots=no",
        "seed=7",
        f"run_root={root}",
        "title=soak",
        "name=soak",
    ]
    if args.small:
        # and 8x8 images and a small eval split: at 32x32 even this model's
        # steps and validations take most of a CPU smoke's minute
        ov += ["task.model.dim=32", "task.model.levels=2", "data.data_shape=[8, 8, 3]", "data.n_val=32",
               "data.eval_batch_size=16"]
    else:
        # the CIFAR recipe's model (configs/experiment/cifar10-vdm.yaml)
        ov += ["task.model.dim=128", "task.model.levels=32", "task.model.dropout=0.1", "task.model.pos_emb_mult=4"]
    if args.device is not None:
        ov.append(f"+trainer.device={args.device}")
    return ov


def _launch(overrides: list[str], log: Path) -> subprocess.Popen:
    with log.open("w") as out:
        return subprocess.Popen([sys.executable, "-m", "bsi_torch.train", *overrides], stdout=out,
                                stderr=subprocess.STDOUT, cwd=REPO_ROOT)


def _metrics_path(root: Path) -> Path | None:
    hits = sorted(root.rglob("metrics.jsonl"))
    return hits[-1] if hits else None


def _read_metrics(path: Path) -> list[dict]:
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass  # a tail line being written
    return out


def _latest_step(root: Path) -> int:
    path = _metrics_path(root)
    if path is None:
        return 0
    return max((r.get("step", 0) for r in _read_metrics(path)), default=0)


def _steps_per_sec(recs: list[dict]) -> list[tuple[int, float]]:
    """(step, steps/s) between consecutive train-loss records."""
    pts = [(r["step"], r["time"]) for r in recs if "train/loss" in r]
    return [(s2, (s2 - s1) / (t2 - t1)) for (s1, t1), (s2, t2) in zip(pts, pts[1:]) if t2 > t1 and s2 > s1]


def _cursor_examples(meta: dict, n_train: int) -> int:
    """Examples the data module has served, from the checkpoint's sampler
    cursor (the nested ``{"epoch", "pos"}`` dict)."""

    def find(d):
        if isinstance(d, dict):
            if set(d) >= {"epoch", "pos"}:
                return d
            for v in d.values():
                got = find(v)
                if got is not None:
                    return got
        return None

    c = find(meta["data_state"])
    if c is None:
        raise AssertionError(f"no cursor in {meta['data_state']}")
    return int(c["epoch"]) * n_train + int(c["pos"])


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.soak_test", description=__doc__.splitlines()[0])
    p.add_argument("--max-steps", type=int, default=50000)
    p.add_argument("--kill-at", type=int, default=25000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--n-train", type=int, default=50000)
    p.add_argument("--small", action="store_true", help="a tiny model, for a smoke run")
    p.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    p.add_argument("--root", default=str(Path(tempfile.gettempdir()) / "bsi_torch_soak"))
    p.add_argument("--out", default=None, help="timeline JSON (default <root>/soak.json)")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before launching anything

    root = Path(args.root)
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    timeline: dict = {"events": [], "config": vars(args)}
    t0 = time.time()

    def ev(name, **kw):
        rec = {"event": name, "t": round(time.time() - t0, 1), **kw}
        timeline["events"].append(rec)
        print(f"[soak +{rec['t']}s] {name} {kw}", flush=True)

    overrides = _overrides(args, root)
    proc = _launch(overrides, root / "run1.log")
    ev("launched", pid=proc.pid, max_steps=args.max_steps)
    try:
        # poll until the kill threshold, then SIGTERM (the maintenance event)
        while True:
            if proc.poll() is not None:
                raise SystemExit(f"run1 exited early rc={proc.returncode}:\n"
                                 + (root / "run1.log").read_text()[-3000:])
            step = _latest_step(root)
            if step >= args.kill_at:
                proc.send_signal(signal.SIGTERM)
                ev("sigterm_sent", at_step=step)
                break
            time.sleep(POLL_S)
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(rc == 0, f"run1 rc={rc}:\n" + (root / "run1.log").read_text()[-3000:])
    ev("run1_exited", rc=rc)

    run_dirs = sorted(d.parent for d in root.rglob("ckpt_interrupt"))
    _check(len(run_dirs) == 1, run_dirs)
    run1 = run_dirs[0]
    meta1 = json.loads((run1 / "ckpt_interrupt" / "meta.json").read_text())
    cursor1 = _cursor_examples(meta1, args.n_train)
    # the cursor advances exactly batch examples a step, so it lands on a
    # step boundary at or just past the kill threshold
    _check(cursor1 % args.batch == 0, (cursor1, args.batch))
    int_step = cursor1 // args.batch
    _check(int_step >= args.kill_at, (int_step, args.kill_at))
    recs1 = _read_metrics(run1 / "metrics.jsonl")
    ev("interrupt_ckpt_verified", step=int_step, cursor_examples=cursor1)

    # requeue from the interrupt checkpoint
    proc2 = _launch(overrides + [f"from_ckpt={run1 / 'ckpt_interrupt'}"], root / "run2.log")
    ev("requeued", pid=proc2.pid, from_step=int_step)
    try:
        rc2 = proc2.wait(timeout=72 * 3600)
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait()
    _check(rc2 == 0, f"run2 rc={rc2}:\n" + (root / "run2.log").read_text()[-3000:])
    ev("run2_exited", rc=rc2)

    run2 = [d.parent for d in root.rglob("ckpt_last") if d.parent != run1]
    _check(len(run2) == 1, run2)
    run2 = run2[0]
    recs2 = _read_metrics(run2 / "metrics.jsonl")
    steps2 = [r["step"] for r in recs2 if "train/loss" in r]
    _check(steps2 and steps2[0] > int_step, (steps2[:3], int_step))
    _check(max(steps2) == args.max_steps, (max(steps2), args.max_steps))
    meta2 = json.loads((run2 / "ckpt_last" / "meta.json").read_text())
    cursor2 = _cursor_examples(meta2, args.n_train)
    _check(cursor2 == args.max_steps * args.batch, (cursor2, args.max_steps))
    ev("continuation_verified", first_logged=steps2[0], final_step=max(steps2), cursor_examples=cursor2)

    # run2's recorded best (restored from run1's meta) is no worse than
    # run1's, and is the least val/bpd logged anywhere
    best1 = float(meta1["extra"]["best_bpd"])
    best2 = float(meta2["extra"]["best_bpd"])
    vals = [r["val/bpd"] for r in recs1 + recs2 if "val/bpd" in r]
    _check(best2 <= best1 + 1e-12, (best1, best2))
    if vals:
        _check(abs(best2 - min(vals)) < 1e-9, (best2, min(vals)))
    ev("best_monotonic", run1_best=best1, run2_best=best2, n_vals=len(vals))

    # steps/s across the kill: each run's first two windows (the kernels'
    # first calls) skipped
    rate1, rate2 = _steps_per_sec(recs1), _steps_per_sec(recs2)
    med1 = statistics.median(r for _, r in rate1[2:]) if len(rate1) > 4 else None
    med2 = statistics.median(r for _, r in rate2[2:]) if len(rate2) > 4 else None
    timeline["steps_per_sec"] = {"run1_median": med1, "run2_median": med2,
                                 "run1_windows": len(rate1), "run2_windows": len(rate2)}
    if med1 and med2:
        drift = abs(med2 - med1) / med1
        timeline["steps_per_sec"]["drift"] = drift
        _check(drift < 0.15, f"steps/s drifted {drift:.1%} across the kill")
    ev("rate_stable", run1=med1, run2=med2)

    out = Path(args.out or root / "soak.json")
    out.write_text(json.dumps(timeline, indent=2))
    print(f"SOAK OK -> {out}")
    return timeline


if __name__ == "__main__":
    main()
