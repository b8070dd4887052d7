"""The benchmark's files: ``BENCHMARK.json`` against its contract, and every
configuration, traffic mix, driver, limits and metric file it names loads."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import harness, kinds, reference

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/") and ".." not in path
        assert (REPO / path).is_dir() and not path.endswith("_torch")
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word and "\n" not in word and not word.startswith("/")


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique_and_configs_used():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_configs_hold_their_reduction_and_no_width_is_cut():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/") and len(c["reduced"]) <= 16
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert c["source"].startswith("https://")


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_reports_what_its_metrics_move(cell):
    c = harness.load_cell(cell)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    assert callable(harness.load_module(harness.HERE / "drivers" / f"{c.traffic['driver']}.py").run)
    assert c.limits and all(isinstance(v, float) and math.isfinite(v) for v in c.limits.values())
    assert c.model is reference.model(c.kind) and c.precision in ("bf16", "f32")
    assert all(callable(getattr(c.model, name)) for name in reference.KIND if not name.isupper())


def test_every_metric_file_is_named():
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("name, kind", [
    ("(anonymous namespace)::k1_attn_fwd_f32_tiled(bsi::fwd::Args)", "K1 attention"),
    ("void (anonymous namespace)::packed_attn_fwd_f32<64>(bsi::fwd::Args)", "K2 fused-qkv attention"),
    ("void (anonymous namespace)::gn_silu_bwd<__nv_bfloat16>((anonymous namespace)::Params)",
     "K7b groupnorm_silu backward"),
    ("ln_mod_fwd", "K4f layernorm_modulate"),
    ("conv3x3_f32_fwd(float const*, float const*, float const*, float*, int, int, int, int, int, int)", "K8f conv3x3"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32", kinds.MATMUL),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int, int, int, int, int, float2)",
     kinds.MATMUL),
    ("void flip_filter<float, float>(float*, float const*, int, int, int, int)", kinds.MATMUL),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", kinds.OPTIMIZER),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, ...>", kinds.ELEMENTWISE),
])
def test_kernel_kinds(name, kind):
    assert kinds.kind(name) == kind


def test_layers_are_perf_md_layers():
    perf = (REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
