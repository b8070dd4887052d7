"""``python -m bsi_torch.scripts.bench_parallel`` (the JAX package's
``scripts/bench_parallel.py``) in one process on the CPU with a narrow DiT:
the production Trainer at ``--dp 1`` for 3 steps, its record; and a mesh
that the world size does not divide raises ``make_mesh``'s message."""

import math

import pytest

from bsi_torch.models import DenoisingDiT
from bsi_torch.nn import FourierFeatures
from bsi_torch.scripts import bench_parallel


def narrow_dit():
    return DenoisingDiT((8, 8, 3), patch_size=2, dim=64, depth=2, heads=2, dropout=0.05,
                        fourier_features=FourierFeatures(6, 8), device="cpu")


@pytest.mark.parametrize("fsdp", [False, True])
def test_dp1_record(fsdp):
    args = bench_parallel.parse_args(["--dp", "1", "--steps", "3", "--batch", "4", "--device", "cpu"]
                                     + (["--fsdp"] if fsdp else []))
    rec = bench_parallel.run(args, model=narrow_dit())
    assert rec["metric"] == f"bsi-dit train throughput (dp1 tp1 pp1{' fsdp' if fsdp else ''}, global batch 4)"
    assert rec["unit"] == "examples/sec/chip" and rec["chips"] == 1
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["value"] == pytest.approx(4 / (rec["step_ms"] / 1e3), rel=1e-9)
    assert rec["wall_s"] > 0
    assert (rec["peak_mem_gib"], rec["device"], rec["power_limit"]) == (None, None, None)  # not a card


@pytest.mark.parametrize("flags, message", [
    (["--tp", "2"], "1 devices not divisible by model_parallelism=2 x pipeline_parallelism=1"),
    (["--pp", "2"], "1 devices not divisible by model_parallelism=1 x pipeline_parallelism=2"),
    (["--dp", "2"], "the mesh needs 2 processes"),
])
def test_mesh_the_world_does_not_fit_raises(flags, message):
    with pytest.raises(ValueError, match=message):
        bench_parallel.run(bench_parallel.parse_args(flags + ["--device", "cpu"]), model=narrow_dit())
