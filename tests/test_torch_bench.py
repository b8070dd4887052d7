"""The port's bench (``bsi_torch/bench.py``, ``bsi_torch/scripts/bench_train.py``)
against the JAX package's (``bench.py``, ``scripts/bench_train.py``).

The builders carry the JAX benches' hyperparameters (read from the flax
module fields, no ``init``; the full-width port models are built on the
``meta`` device, so no weights are made); the timing functions run on the
CPU at tiny widths and count their FLOPs as their docstrings say; and
``bench.main`` keeps the JAX protocol: one record a row the moment it
exists, bounded retries before an error record, the combined last line
with its fallback ``value``, and (unlike JAX) exit code 1 when a row
failed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import bsi_torch.profile_sampling as ps
from bsi_torch import bench
from bsi_torch.models import DenoisingDiT, DenoisingVDMUNet
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding
from bsi_torch.profile_sampling import build_algo, count_flops
from bsi_torch.scripts import bench_train

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_bench():
    """The repo's ``bench.py`` (which imports ``scripts/bench_train.py``),
    with the compilation cache off so that no ``.jax_cache`` is written."""
    path = list(sys.path)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("BSI_TPU_CACHE_DIR", "off")
            spec = importlib.util.spec_from_file_location("jax_root_bench", REPO / "bench.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
    finally:
        sys.path[:] = path  # bench.py puts scripts/ first
    return module


@pytest.fixture
def meta_models(monkeypatch):
    """Build the port's full-width models on the meta device: no weights,
    so ``fill_ada_out`` (whose generator needs a real device) is recorded
    instead of run."""
    filled = []
    monkeypatch.setattr(ps, "fill_ada_out", lambda model, seed: filled.append(seed))
    return filled


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def unet_fields(model: DenoisingVDMUNet) -> dict:
    dropouts = {m.p for m in model.modules() if isinstance(m, nn.Dropout)}
    return dict(
        data_shape=model.data_shape, dim=model.encode.out_channels, levels=model.unet.levels,
        pos_emb=(model.pos_emb.size, model.pos_emb.expected_rate),
        pos_emb_mult=model.pos_map_1.out_features // model.pos_emb.size,
        n_attention_heads=model.unet.Attention2D_0.heads, dropout=dropouts.pop() if dropouts else None,
        fourier=(model.fourier_features.n_min, model.fourier_features.n_max), dtype=dtype_name(model.encode.dtype),
    )


def jax_unet_fields(m) -> dict:
    return dict(
        data_shape=tuple(m.data_shape), dim=m.dim, levels=m.levels, pos_emb=(m.pos_emb.size, m.pos_emb.expected_rate),
        pos_emb_mult=m.pos_emb_mult, n_attention_heads=m.n_attention_heads, dropout=m.dropout,
        fourier=(m.fourier_features.n_min, m.fourier_features.n_max), dtype=str(np.dtype(m.dtype)),
    )


def dit_fields(model: DenoisingDiT) -> dict:
    block = model.dit.block_0
    return dict(
        data_shape=model.data_shape, patch_size=model.dit.patch_size, dim=model.dit.hidden_size, depth=model.dit.depth,
        heads=block.attn.heads, dropout=block.dropout.p if block.dropout is not None else None,
        attention_dropout=block.attn.dropout, remat=model.dit.remat,
        fourier=(model.fourier_features.n_min, model.fourier_features.n_max), dtype=dtype_name(block.ada_in.dtype),
    )


def jax_dit_fields(m) -> dict:
    return dict(
        data_shape=tuple(m.data_shape), patch_size=m.patch_size, dim=m.dim, depth=m.depth, heads=m.heads,
        dropout=m.dropout, attention_dropout=m.dropout or 0.0, remat=m.remat,
        fourier=(m.fourier_features.n_min, m.fourier_features.n_max), dtype=str(np.dtype(m.dtype)),
    )


def algo_fields(algo) -> dict:
    return {key: (tuple(getattr(algo, key)) if key == "data_shape" else getattr(algo, key))
            for key in ("data_shape", "lambda_0", "alpha_M", "alpha_R", "k", "preconditioning")}


def test_sampling_builders_match_jax(jax_bench, meta_models):
    assert unet_fields(bench.build_model("unet", "meta")) == jax_unet_fields(jax_bench._build_unet())
    assert dit_fields(bench.build_model("dit", "meta")) == jax_dit_fields(jax_bench._make_dit(scan_blocks=False))
    assert meta_models == [0]  # the DiT's ada_out filled, from the seed
    assert algo_fields(bench.build_algo(bench.K_STEPS)) == algo_fields(jax_bench._build_algo())
    assert (bench.K_STEPS, bench.BATCH, bench.RETRIES) == (jax_bench.K_STEPS, jax_bench.BATCH, jax_bench.RETRIES)
    for name in ("UNET", "DIT", "UNET_TRAIN", "DIT_TRAIN"):
        assert getattr(bench, f"A100_BASELINE_{name}") == getattr(jax_bench, f"A100_BASELINE_{name}")


@pytest.mark.parametrize("name", ["unet", "dit"])
def test_train_builders_match_jax(jax_bench, meta_models, monkeypatch, name):
    import bsi_tpu.train

    from bsi_torch.train import warmup_cosine_schedule

    captured = {}
    jax_make_optimizer, jax_schedule = bsi_tpu.train.make_optimizer, bsi_tpu.train.warmup_cosine_schedule

    def capture_optimizer(schedule, **kw):
        captured.update(kw)
        return jax_make_optimizer(schedule, **kw)

    def capture_schedule(*args, **kw):
        captured["schedule"] = (args, kw)
        return jax_schedule(*args, **kw)

    monkeypatch.setattr(bsi_tpu.train, "make_optimizer", capture_optimizer)
    monkeypatch.setattr(bsi_tpu.train, "warmup_cosine_schedule", capture_schedule)
    moments = dict(mu_dtype="bfloat16", nu_dtype="bfloat16") if name == "dit" else dict(mu_dtype=None)
    j_model, j_algo, _, j_ema, j_batch = jax_bench._bench_train.build(name, remat=name == "dit", batch=None, **moments)
    model, algo, tx, ema, batch = bench_train.build(name, "meta", remat=name == "dit", **moments)

    fields, jax_fields = (unet_fields, jax_unet_fields) if name == "unet" else (dit_fields, jax_dit_fields)
    assert fields(model) == jax_fields(j_model)
    assert model.training
    assert algo_fields(algo) == algo_fields(j_algo)
    assert batch == j_batch
    assert dataclasses.asdict(ema) == dataclasses.asdict(j_ema)
    assert (tx.mu_dtype, tx.nu_dtype) == tuple(getattr(torch, d) if d else None for d in
                                               (captured.get("mu_dtype"), captured.get("nu_dtype")))
    assert (tx.weight_decay, tx.gradient_clip, tx.b1, tx.b2, tx.eps, tx.decoupled) == (0.01, 1.0, 0.9, 0.999, 1e-8, True)
    # the port's schedule (which rounds as optax does in f32) at JAX's lr,
    # warmup and horizon
    args, kw = captured["schedule"]
    for step in (0, 50, 100, 10**4):
        assert np.float64(tx.schedule(step)) == np.float64(warmup_cosine_schedule(*args, **kw)(step)), step


def narrow(name: str, dropout: float | None):
    torch.manual_seed(0)
    if name == "unet":
        return DenoisingVDMUNet((8, 8, 3), NyquistPositionalEmbedding(32, 100), dim=32, levels=1, dropout=dropout,
                                fourier_features=FourierFeatures(6, 8), device="cpu")
    return DenoisingDiT((8, 8, 3), patch_size=2, dim=64, depth=2, heads=2, dropout=dropout,
                        fourier_features=FourierFeatures(6, 8), device="cpu")


TRAIN_KEYS = {"metric", "value", "unit", "step_ms", "final_loss", "remat", "mu_dtype", "nu_dtype", "accum",
              "tflops_per_sec", "flops_model", "peak_mem_gib", "device", "power_limit", "tflop_per_step"}


@pytest.mark.parametrize("name", ["unet", "dit"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_run_on_the_cpu(name, accum):
    model = narrow(name, bench_train.DROPOUT[name])
    windows = []
    rec = bench_train.run(name, batch=4, steps=2, accum=accum, device="cpu", model=model,
                          window=lambda: windows.append(True))
    assert TRAIN_KEYS <= set(rec) and "mfu" not in rec  # no card, no peak
    assert windows == [True]
    assert rec["steps"] == 2 and rec["step"] == 3 and rec["accum"] == accum
    assert rec["device"] is None and rec["peak_mem_gib"] is None
    with torch.no_grad():
        fwd = sum(count_flops(model, lambda: model(torch.zeros(4 // accum, 8, 8, 3), torch.full((4 // accum,), 0.5)))
                  .values())
    assert fwd > 0 and rec["tflop_per_step"] * 1e12 == pytest.approx(3 * fwd * accum, rel=1e-12)
    # the rate counts every timed step: FLOPs of a step x steps over the elapsed time
    assert rec["tflops_per_sec"] == pytest.approx(rec["tflop_per_step"] * 1e3 / rec["step_ms"], rel=1e-9)
    assert rec["value"] == pytest.approx(4 * 1e3 / rec["step_ms"], rel=1e-9)
    assert np.isfinite(rec["final_loss"])


@pytest.mark.parametrize("name", ["unet", "dit"])
def test_bench_sampling_on_the_cpu(name):
    model = narrow(name, None).eval()
    algo = build_algo(3, 8)
    runs = []
    rec = bench.bench_sampling(model, algo, batch=2, n_iters=2, before_run=lambda: runs.append("before"),
                               after_run=lambda samples: runs.append(tuple(samples.shape)))
    assert runs == ["before", (2, 8, 8, 3)] * 2
    assert {"value", "unit", "run_s", "sample_ms", "tflops_per_sec", "tflop_per_run", "flops_model", "peak_mem_gib",
            "device", "power_limit"} <= set(rec)
    with torch.inference_mode():
        fwd = sum(count_flops(model, lambda: model(torch.zeros(2, 8, 8, 3), torch.full((2,), 0.5))).values())
    assert rec["tflop_per_run"] * 1e12 == pytest.approx(fwd * (algo.k + 1), rel=1e-12)
    assert rec["tflops_per_sec"] == pytest.approx(rec["tflop_per_run"] * 2 / sum(rec["run_s"]), rel=1e-9)
    assert rec["value"] == pytest.approx(4 / sum(rec["run_s"]), rel=1e-9)


def test_main_protocol(monkeypatch, capsys):
    """Each record printed at once; RETRIES attempts before an error record;
    the last line the combined record with the fallback value; exit code 1."""
    calls, printed_before = [], {}

    def measure(label, device=None):
        calls.append(label)
        printed_before[label] = capsys.readouterr().out  # what was printed before this row ran
        if label == "unet-sampling":
            raise RuntimeError("no luck")
        return {"value": float(len(calls)), "unit": "u"}

    monkeypatch.setattr(bench, "measure", measure)
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    code = bench.main(device="cpu")
    out = "".join(printed_before.values()) + capsys.readouterr().out
    lines = [json.loads(line) for line in out.splitlines()]
    assert calls[:bench.RETRIES] == ["unet-sampling"] * bench.RETRIES
    assert calls[bench.RETRIES:] == ["dit-sampling", "unet-train", "dit-train", "dit-train-b512"]
    # the error record was printed before the next row ran
    assert json.loads(printed_before["dit-sampling"].splitlines()[-1])["error"] == "RuntimeError: no luck"
    assert len(lines) == 6
    assert lines[0]["metric"].startswith("bsi-cifar10-unet sampling") and "vs_baseline" not in lines[0]
    assert lines[1]["vs_baseline"] == lines[1]["value"] / bench.A100_BASELINE_DIT
    combined = lines[-1]
    assert combined["value"] == lines[1]["value"]  # the fallback: the first row with a value
    assert combined["train"] == {"unet": lines[2], "dit": lines[3], "dit_b512": lines[4]}
    assert code == 1


def test_main_exit_code_0_when_every_row_has_a_value(monkeypatch, capsys):
    monkeypatch.setattr(bench, "measure", lambda label, device=None: {"value": 1.0})
    assert bench.main(device="cpu") == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["value"] == 1.0


def test_commands_refuse_the_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("there is a card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench_train.run("unet", model=narrow("unet", 0.1))
