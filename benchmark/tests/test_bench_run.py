"""A run without the card, and the modules a run and the reference load."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]


def run(code: str, env_extra: dict | None = None) -> subprocess.CompletedProcess:
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1", **(env_extra or {})}
    return subprocess.run([sys.executable, *code], cwd=REPO, capture_output=True, text=True, env=env, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = run(["-m", "benchmark.run", "--workload", "dit-l2-in32.train-b64", "--seed", "4294967311",
                "--seconds", "1", "--trace", "0"])
    assert proc.returncode != 0
    assert "needs 1 CUDA device" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_the_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "bsi_tpu_notes", sys)
    assert harness.forbidden_modules() == [m for m in harness.FORBIDDEN if m in {n.split(".")[0] for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


@pytest.mark.parametrize("code, excluded", [
    # a run's modules: the harness, a driver, the port, the reference
    ("import time, torch; from benchmark import harness; from benchmark.tests import tiny; "
     "c = tiny.cell('dit-l2-in32.sample-k20-b128'); "
     "d = harness.load_module(harness.HERE / 'drivers' / 'sample.py'); "
     "d.run(c, seed=5, seconds=0.2, trace=False, t0=time.time(), device=torch.device('cpu'))",
     ("jax", "jaxlib", "flax", "bsi_tpu")),
    # the reference alone: not the port either
    ("import benchmark.reference.steps, benchmark.reference.draws, benchmark.reference.optim",
     ("jax", "jaxlib", "flax", "bsi_tpu", "bsi_torch")),
])
def test_loaded_top_level_modules(code, excluded):
    proc = run(["-c", code + "; import sys, json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert not loaded & set(excluded), loaded & set(excluded)
