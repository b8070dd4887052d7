"""The port's entry point, ``python -m bsi_torch.train``, in a subprocess on
the CPU: a debug run to its end, imports of neither JAX nor the JAX package,
a sweep, and no silent fall back to the CPU."""

import json
import subprocess
import sys
from pathlib import Path

from torch_tiny import tiny_overrides

REPO = Path(__file__).resolve().parents[1]


def run(args, **kw):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=300, **kw)


def test_debug_run_on_the_cpu(tmp_path):
    overrides = tiny_overrides(tmp_path, "mode=debug", "trainer.plots=yes")
    code = ("import sys; from bsi_torch.train.__main__ import main; rc = main(sys.argv[1:]); "
            "print('IMPORTED', sorted(m for m in ('jax', 'bsi_tpu', 'yaml', 'PIL') if m in sys.modules)); "
            "sys.exit(rc)")
    out = run(["-c", code, *overrides])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED []" in out.stdout
    assert "best val/bpd:" in out.stdout
    (run_dir,) = (tmp_path / "exploring").iterdir()
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2]  # mode=debug: 2 steps
    assert any("val/bpd" in r for r in records)
    for tag in ("last", "best"):
        assert (run_dir / f"ckpt_{tag}" / "state.pt").exists()
        meta = json.loads((run_dir / f"ckpt_{tag}" / "meta.json").read_text())
        assert meta["config"]["trainer"]["device"] == "cpu" and meta["data_state"]["stream"]["pos"] == 8
    assert sorted(p.name for p in (run_dir / "plots" / "step_2").iterdir()) == [
        "val_denoisings.png", "val_histories.png", "val_samples.png"]
    assert json.loads((run_dir / "config.json").read_text())["seed"] == 5


def test_module_entry_point_and_sweep(tmp_path):
    overrides = [ov for ov in tiny_overrides(tmp_path, "mode=debug") if not ov.startswith("seed=")]
    out = run(["-m", "bsi_torch.train", "-m", *overrides, "seed=1,2"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "=== run 1/2" in out.stdout and "=== run 2/2" in out.stdout
    assert out.stdout.strip().splitlines()[-1].startswith("best val/bpd: ")
    assert len(list((tmp_path / "exploring").iterdir())) == 2


def test_without_a_card_or_a_cpu_request_it_raises(tmp_path):
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would train on it")
    overrides = [ov for ov in tiny_overrides(tmp_path, "mode=debug") if ov != "+trainer.device=cpu"]
    out = run(["-m", "bsi_torch.train", *overrides])
    assert out.returncode != 0
    assert "runs on a CUDA device by default" in out.stderr
    assert not list(tmp_path.glob("exploring/*/ckpt_*"))
