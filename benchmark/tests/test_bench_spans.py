"""The readers of the program's spans (``benchmark/spans.py`` and the
``program_span`` metrics), ``trace.read``'s readings, and the program's
``ops.*`` counters against the calls that the model kinds' files count."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, kinds, spans
from benchmark import trace as tracing
from benchmark.tests import tiny
from bsi_torch.utils import profiling
from bsi_torch.utils.profiling import Span

MS = 1_000_000  # ns
BASE = 5 * MS  # the first span's start on the host's clock


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def train_spans() -> list:
    """Two steps: input spans of 1 + 0.5 ms each; forward, backward and
    update of 10 and 12, 20 and 22, 5 and 7 device ms."""
    out = []
    for i, t0 in enumerate((BASE, BASE + 100 * MS)):
        out += [Span("data.batch", t0, t0 + MS), Span("train.to_device", t0 + MS, t0 + 3 * MS // 2),
                Span("step", t0 + 2 * MS, t0 + 40 * MS, attrs={"step": i})]
        out += [Span(name, t0 + 2 * MS, t0 + 3 * MS, parent=len(out) - 1, device_ms=ms)
                for name, ms in (("step.forward", 10.0 + 2 * i), ("step.backward", 20.0 + 2 * i),
                                 ("step.update", 5.0 + 2 * i))]
    return out


def read(name: str):
    metric = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
    return metric.read(SimpleNamespace(trace=None))


@pytest.mark.parametrize("name, want", [
    ("forward_ms.train.dit-l2-in32", 11.0),
    ("backward_ms.train.dit-l2-in32", 21.0),
    ("update_ms.train.dit-l2-in32", 6.0),
    ("input_ms.train.dit-l2-in32", 1.5),
])
def test_train_readers_on_hand_built_spans(name, want, monkeypatch):
    found = train_spans()
    monkeypatch.setattr(spans, "recorded", lambda: found)
    assert read(name) == pytest.approx(want)
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert read(name) is None


def test_denoiser_reads_a_forward_of_the_sampling_call(monkeypatch):
    found = [Span("sample", BASE, BASE + 10 * MS)]
    found += [Span("sample.denoise", BASE, BASE + MS, device_ms=480.0 + i) for i in range(21)]
    monkeypatch.setattr(spans, "recorded", lambda: found)
    assert read("denoiser_ms.sample") == pytest.approx(490.0)
    found[3].device_ms = None  # a span on the CPU
    assert read("denoiser_ms.sample") is None


def test_a_program_without_the_recorder_gives_no_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert spans.recorded() == []
    assert read("forward_ms.train.dit-l2-in32") is None


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_read_keeps_its_readings():
    events = [
        event("kernel", "ln_mod_fwd", 0.0, 10.0),
        event("kernel", "sm90_xmma_gemm_bf16", 5.0, 10.0),
        event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 20.0, 2.0),
        event("cuda_runtime", "cudaLaunchKernel", 25.0, 10.0),
        event("kernel", "void at::native::reduce_kernel<128, 4>", 40.0, 5.0),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50.0},
    ]
    t = tracing.read(events, 1.5)
    assert t.window_s == 1.5 and t.busy_s == pytest.approx(22e-6)
    assert t.by_kind == pytest.approx({"K4f layernorm_modulate": 10e-6, kinds.MATMUL: 10e-6, kinds.TRANSFER: 2e-6,
                                       kinds.ELEMENTWISE: 5e-6})
    assert [label for label, _ in t.gaps] == ["cudaLaunchKernel", f"host, before {kinds.TRANSFER}"]
    assert [s for _, s in t.gaps] == pytest.approx([18e-6, 5e-6])
    assert t.holes == [(22.0, 40.0), (15.0, 20.0)] and t.base_ns is None


BASE_NS = 1_700_000_000 * 10**9  # a trace's baseTimeNanoseconds


def at(us: float) -> int:
    """A trace's time (µs) on the spans' clock."""
    return BASE_NS + int(us * 1000)


def synthetic():
    """Device operations over 0-1200 µs, with idle holes at 120-160 (inside
    ``data.batch``), 180-250 (``train.to_device``), 320-400 and 450-700
    (``step.forward``) and 1000-1100 (between two steps, in no span)."""
    busy = [(0, 120), (160, 180), (250, 320), (400, 450), (700, 1000), (1100, 1200)]
    events = [event("kernel", "ln_mod_fwd", a, b - a) for a, b in busy]
    found = [Span("data.batch", at(100), at(200)), Span("train.to_device", at(200), at(230)),
             Span("step", at(300), at(1000)), Span("step.forward", at(300), at(600), parent=2),
             Span("step", at(1100), at(1200))]
    return tracing.read(events, 0.0012, BASE_NS), found


def test_input_idle_reads_the_holes_inside_the_input_spans(monkeypatch):
    trace, found = synthetic()
    monkeypatch.setattr(spans, "recorded", lambda: found)
    metric = harness.load_module(harness.HERE / "metrics" / "input_idle_ms.train.dit-l2-in32.py")
    assert metric.read(SimpleNamespace(trace=trace)) == pytest.approx((40 + 70) / 1e3 / 2)
    for without in (None, tracing.Trace(window_s=trace.window_s, busy_s=trace.busy_s, holes=trace.holes)):
        assert metric.read(SimpleNamespace(trace=without)) is None
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert metric.read(SimpleNamespace(trace=trace)) is None


def test_device_busy_reads_the_union_of_device_intervals_a_step():
    trace, _ = synthetic()
    metric = harness.load_module(harness.HERE / "metrics" / "device_busy_ms.train.dit-l2-in32.py")
    busy_us = 120 + 20 + 70 + 50 + 300 + 100
    assert metric.read(SimpleNamespace(trace=trace, steps=2)) == pytest.approx(busy_us / 1e3 / 2)
    for without in (None, tracing.Trace(window_s=trace.window_s, busy_s=0.0)):
        assert metric.read(SimpleNamespace(trace=without, steps=2)) is None


def test_the_breakdown_labels_each_gap_with_its_innermost_span(monkeypatch):
    trace, found = synthetic()
    before = f"host, before {kinds.kind('ln_mod_fwd')}"
    monkeypatch.setattr(spans, "recorded", lambda: found)
    gaps = harness.breakdown(trace)["idle_gaps"]
    assert [label for label, _ in gaps] == [f"{before} [step.forward]", before, f"{before} [step.forward]",
                                            f"{before} [train.to_device]", f"{before} [data.batch]"]
    assert [s for _, s in gaps] == pytest.approx([250e-6, 100e-6, 80e-6, 70e-6, 40e-6])
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert [label for label, _ in harness.breakdown(trace)["idle_gaps"]] == [before] * 5


def attention_and_norm_counters(found: dict) -> tuple:
    total = lambda *ops: sum(n for key, n in found.items() if key.split(".")[1] in ops)
    return total("K1", "K2", "K5f"), total("K3", "K5b"), total("K4f", "K7f"), total("K4b", "K7b")


def called(calls: list) -> int:
    return sum(n for _, n in calls)


def test_op_counters_of_a_train_step_are_the_counted_calls():
    cell = tiny.cell("dit-l2-in32.train-b64", precision="32")
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    trainer, data, *_ = drv.setup(cell, harness.seeds(5), torch.device("cpu"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.state, _ = trainer._train_step(trainer.state, trainer._to_device(next(data.train_batches())))
    found = profiling.counters()
    assert all(key.endswith(".plain") for key in found)
    args = (cell.reference_model(), cell.traffic["batch"], cell.precision)
    fwd_attn, bwd_attn = cell.model.attention_calls(*args, backward=True)
    norm = cell.model.norm_calls(*args, backward=True)
    assert attention_and_norm_counters(found) == (fwd_attn[1], bwd_attn[1], called(norm[:len(norm) // 2]),
                                                  called(norm[len(norm) // 2:]))
    assert found.get("ops.K8f.plain", 0) == called(cell.model.conv3x3_calls(*args))


def test_op_counters_of_a_unet_forward_are_the_counted_calls():
    from bsi_torch.tasks.task import build_model

    cell = tiny.cell("vdm-unet-c10.sample-k20-b128")
    model = build_model(cell.config["program"]["task"]["model"], tuple(cell.config["data_shape"]), device="cpu")
    mu = torch.zeros((2, *cell.config["data_shape"]))
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model.eval()(mu, torch.full((2,), 0.5))
    args = (cell.reference_model(), 2, cell.precision)
    found = profiling.counters()
    assert attention_and_norm_counters(found) == (
        called(cell.model.attention_calls(*args, backward=False)), 0,
        called(cell.model.norm_calls(*args, backward=False)), 0)
    assert found["ops.K8f.plain"] == called(cell.model.conv3x3_calls(*args)) == 11  # 4 levels + 7 at one level


def test_a_traced_train_run_on_the_cpu_reads_the_host_spans():
    """Past the harness's look for a card: the host's spans read, the device's
    give nothing."""
    cell = tiny.cell("dit-l2-in32.train-b64", precision="32")
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    out = drv.run(cell, seed=3400000011, seconds=0.5, trace=True, t0=time.time(), device=torch.device("cpu"))
    metrics = harness.per_layer(cell, out.info)
    assert metrics["input_ms.train.dit-l2-in32"]["value"] > 0
    for name in ("forward_ms", "backward_ms", "update_ms", "input_idle_ms"):
        assert f"{name}.train.dit-l2-in32" not in metrics
    assert out.trace.base_ns is not None
    assert sum(1 for s in profiling.spans() if s.name == "step") == out.info.steps
